"""Torch ports of the reference's three LM examples (``examples/`` at
the root of the repository, which stay as they are), each run as
``python -m repro_torch.examples.<name>``, on the card unless
``--device cpu``:

  quickstart     -- build an architecture's smoke variant, train it a few
                    steps and decode from it greedily;
  serve_batched  -- batched prefill + decode across three families
                    (dense GQA, pure SSM, hybrid MoE);
  train_lm_ol4el -- an LM trained with the OL4EL edge-cloud loop through
                    ``ELSession`` and ``LMExecutor``, then checkpointed.
"""
