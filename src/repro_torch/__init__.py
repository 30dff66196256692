"""FedSiKD in PyTorch for one NVIDIA H100: the port of ``repro`` (JAX/Pallas).

The JAX package stays the reference; this package imports nothing of it.
Its entry point is ``repro_torch.fed.rounds.run_federated(ds, cfg, *,
device="cuda")``, and its hand-written CUDA kernels live in
``repro_torch.kernels`` (sources under ``kernels/csrc/``).
"""
