"""The port's hand-written CUDA kernels (``csrc/``), their ctypes wrappers,
plain versions and public entry points (``ops``).

``KERNELS`` maps each kernel's name to its wrapper; every wrapper carries a
``launches`` count that goes up by one where it launches its kernel.
Each also counts them by kind (``variant_launches``):
``flash_attention`` by the kernel each call took (``v1``, ``tensor_core``,
``decode``), ``fused_merge`` by entry (``leaf``: one (N, D) stack,
``leaves``: every leaf of N clients' parameters in one launch),
``kmeans_assign`` by regime (``split``, ``stream``) and the KD forward and
backward (``kd_loss_fwd``, ``kd_loss_bwd``) by regime (``rows``,
``stream``); ``reset_launches`` zeroes those too, and
``fused_merge.stale_launches`` (its launches that merge a late update).
"""
from repro_torch.kernels import (flash_attention, fused_merge, kd_softmax_kl,
                                 kmeans_assign, ops, ref)

KERNELS = {
    "kd_softmax_kl_fwd": kd_softmax_kl.kd_loss_fwd,
    "kd_softmax_kl_bwd": kd_softmax_kl.kd_loss_bwd,
    "fused_merge": fused_merge.fused_merge,
    "kmeans_assign": kmeans_assign.kmeans_assign,
    "flash_attention": flash_attention.flash_attention,
}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for fn in (flash_attention.flash_attention, fused_merge.fused_merge,
               kmeans_assign.kmeans_assign, kd_softmax_kl.kd_loss_fwd,
               kd_softmax_kl.kd_loss_bwd):
        for kind in fn.variant_launches:
            fn.variant_launches[kind] = 0
    fused_merge.fused_merge.stale_launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = ["flash_attention", "fused_merge", "kd_softmax_kl", "kmeans_assign", "ops", "ref",
           "KERNELS", "reset_launches", "launch_counts"]
