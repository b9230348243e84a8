"""``repro_torch`` — the OL4EL runtime in PyTorch, for NVIDIA Hopper.

A second package beside the JAX reference ``repro``, laid out like it so
each module has an obvious counterpart.  It imports ``torch`` and numpy
only — nothing of ``jax`` and nothing of ``repro`` — and keeps its own
copies of the numpy control plane (bandit, policies, coordinator, data
generators).  Parity with the reference is held by the tests, which
import both packages.

Slices so far:

* the paper's host loop: ``ELSession.run_sync`` / ``run_async(
  rng_streams="numpy")`` over a ``ClassicExecutor`` training the linear
  SVM or minibatch K-means, whose E-step is the hand-written CUDA kernel
  in ``csrc/kmeans_assign.cu``;
* mamba2-370m serving: ``serving.ServingEngine`` over ``models.LM``'s
  ``prefill`` / ``decode_step`` (pure-SSM blocks), every Mamba layer's
  prefill through the hand-written CUDA kernel in ``csrc/ssd_scan.cu``
  (``python -m repro_torch.launch.serve --arch mamba2-370m``).

Every entry point takes ``device=``; ``None`` means CUDA and raises when
there is no card (``repro_torch.device.resolve_device``).
"""
