"""Hand-written Hopper kernels for the port's hot spots.

Each kernel mirrors the reference's three files under
``repro_torch/kernels/<name>/``, with its CUDA C++ source in
``repro_torch/csrc/<name>.cu``:
  kernel.py -- builds the source (``_build``) and launches it via ctypes,
  ops.py    -- the public wrapper: checks, path choice by device, and a
               ``launches`` count,
  ref.py    -- the plain PyTorch version (the CPU path and the oracle).

Kernels:
  kmeans_assign -- K-means E-step (the paper's own workload hot spot),
                   launched by every local step of the EL loop;
  ssd_scan      -- Mamba-2 chunked SSD forward, launched by every Mamba
                   layer's prefill on the serving path (mamba2-370m
                   through ``serving.ServingEngine``).
"""
