"""The port's hand-written CUDA kernels (``csrc/``), their ctypes wrappers,
plain versions and public entry points (``ops``).

``KERNELS`` maps each kernel's name to its wrapper; every wrapper carries a
``launches`` count that goes up by one where it launches its kernel.
``flash_attention`` also counts its calls by the kernel each took
(``variant_launches``: ``v1``, ``tensor_core``, ``decode``);
``reset_launches`` zeroes those too.
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
    counts = flash_attention.flash_attention.variant_launches
    for kind in counts:
        counts[kind] = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = ["flash_attention", "fused_merge", "kd_softmax_kl", "kmeans_assign", "ops", "ref",
           "KERNELS", "reset_launches", "launch_counts"]
