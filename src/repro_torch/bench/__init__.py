"""The paper's figure harness on the port: Fig. 3/4/5 replications, the
policy ablation, the churn baselines and the §V testbed.

    python -m repro_torch.bench.run [--fast | --full] [--device cpu]

The port of the JAX package's ``benchmarks/`` figure half (and of
``examples/el_svm_testbed.py``): the same rows, sizes and CSV names, run
through ``repro_torch.el.ELSession`` on the card unless ``--device``
says otherwise.
"""
