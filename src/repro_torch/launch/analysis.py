"""Roofline analysis probes: the port of ``repro.launch.analysis``.

JAX fits per-layer marginals from reduced-depth probes because XLA's
``cost_analysis`` counts a while loop's body once.  The port's dry run
counts every layer (its layers are a Python loop), so here the probes
check the dry run, and stand in for it where a full-depth run on fake
tensors takes too long (each fake op costs a few hundred microseconds on
the host, and a full-depth train step runs 10^5 of them): the fit
reproduces the full-depth count of FLOPs and bytes, both exactly linear in
the depth.  Each probe is ``dryrun.lower_one`` at full width (grad
accumulation 1 unless given; its Adam moments in the dtype the full model
takes), and the linear model

    X(L) = intercept + L * per_layer

is fitted and taken to the full depth; the hybrid fits group and Mamba2
marginals from three probes, the encoder-decoder encoder and decoder
marginals, and the ``fedsikd`` step teacher and student marginals (the
student's depth set through ``student_layer_keep``).  The peak memory is
fitted the same way (``peak_bytes``): linear as long as the probes and the
full depth peak at the same point of the step.

  PYTHONPATH=src python -m repro_torch.launch.analysis [--arch A] [--shape S]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import traceback
from pathlib import Path

from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES
from repro_torch.launch.dryrun import arch_config, lower_one, shape_skip_reason

FIELDS = ("flops_per_device", "hbm_bytes_per_device",
          "collective_bytes_per_device", "peak_bytes")


def _probe(arch, shape, cfg, **kw):
    r = lower_one(arch, shape, cfg=cfg, verbose=False, **kw)
    out = {f: r["roofline"][f] for f in FIELDS[:3]}
    mem = r["memory_analysis"]
    out["peak_bytes"] = (mem["argument_size_in_bytes"]
                         + mem["temp_size_in_bytes"])
    return out


def _lin(x1, x2, l1, l2, L):
    """intercept + L*slope through (l1,x1),(l2,x2).

    A probe pair whose slope is not positive falls back to the
    zero-intercept estimate X(l2)/l2 * L, as in JAX (a count that does not
    grow with depth, the collective bytes on one card, stays 0)."""
    out = {}
    for f in FIELDS:
        slope = (x2[f] - x1[f]) / (l2 - l1)
        if slope <= 0:
            out[f] = x2[f] / l2 * L
        else:
            out[f] = max(x1[f] + (L - l1) * slope, 0.0)
    return out


def extrapolate(arch: str, shape, *, base=None, step_kind: str = "auto",
                accum: int = 1, device="cuda", **kw) -> dict:
    """The full-depth ``FIELDS`` of ``arch`` x ``shape`` from probes.
    ``base`` overrides the config (a caller's cut of experts, a smaller
    width in the tests); its depth is the one extrapolated to.  Other
    keywords go to ``lower_one`` (the fedsikd step's loss path and
    replicas)."""
    base = base or arch_config(arch, shape if isinstance(shape, str)
                               else "")
    kw.update(step_kind=step_kind, accum=accum, device=device, opt_cfg=base)

    def probe(**over):
        return _probe(arch, shape, dataclasses.replace(base, **over), **kw)

    if step_kind == "fedsikd":
        if base.arch_type in ("hybrid", "audio"):
            raise ValueError(f"{arch}: the fedsikd fit takes one layer "
                             "stack (teacher and student marginals)")
        # X = a + Lt * teacher + Ls * student; probes (Lt, Ls):
        #   pA=(2,1): a + 2t + s   pB=(3,1): a + 3t + s   pC=(4,2)
        pA = probe(num_layers=2, student_layer_keep=0.5)
        pB = probe(num_layers=3, student_layer_keep=1 / 3)
        pC = probe(num_layers=4, student_layer_keep=0.5)
        Ls = base.as_student().num_layers
        out = {}
        for f in FIELDS:
            t = max(pB[f] - pA[f], 0.0)
            s = max(pC[f] - pA[f] - 2 * t, 0.0)
            a = max(pA[f] - 2 * t - s, 0.0)
            out[f] = a + base.num_layers * t + Ls * s
        return out
    if base.arch_type == "hybrid":
        # X = a + G*attn + L*mamba.  Probes (L, attn_every):
        #   pA=(2,2): a + attn + 2 mamba     pB=(3,3): a + attn + 3 mamba
        #   pC=(4,2): a + 2 attn + 4 mamba
        pA = probe(num_layers=2, attn_every=2)
        pB = probe(num_layers=3, attn_every=3)
        pC = probe(num_layers=4, attn_every=2)
        G = base.num_layers // base.attn_every
        out = {}
        for f in FIELDS:
            mamba = max(pB[f] - pA[f], 0.0)
            attn = max(pC[f] - pA[f] - 2 * mamba, 0.0)
            a = max(pA[f] - attn - 2 * mamba, 0.0)
            out[f] = a + G * attn + base.num_layers * mamba
        return out
    if base.arch_type == "audio":
        p22 = probe(num_layers=2, num_encoder_layers=2)
        p32 = probe(num_layers=3, num_encoder_layers=2)
        p23 = probe(num_layers=2, num_encoder_layers=3)
        out = {}
        for f in FIELDS:
            md = max(p32[f] - p22[f], 0.0)
            me = max(p23[f] - p22[f], 0.0)
            a = max(p22[f] - 2 * md - 2 * me, 0.0)
            out[f] = (a + base.num_layers * md
                      + base.num_encoder_layers * me)
        return out
    p1 = probe(num_layers=2)
    p2 = probe(num_layers=3)
    return _lin(p1, p2, 2, 3, base.num_layers)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the device the fake tensors name (cuda|cpu)")
    ap.add_argument("--out", default="results/roofline_probes_torch.json")
    args = ap.parse_args()

    out = Path(args.out)
    results = json.loads(out.read_text()) if out.exists() else []
    done = {(r["arch"], r["shape"]) for r in results}

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    for arch in archs:
        for shape in shapes:
            if (arch, shape) in done or shape_skip_reason(arch, shape):
                continue
            try:
                terms = extrapolate(arch, shape, device=args.device)
                results.append({"arch": arch, "shape": shape, **terms})
                print(f"  probe {arch} x {shape}: "
                      f"flops={terms['flops_per_device']:.3e} "
                      f"hbm={terms['hbm_bytes_per_device']:.3e} "
                      f"coll={terms['collective_bytes_per_device']:.3e} "
                      f"peak={terms['peak_bytes']:.3e}", flush=True)
            except Exception as e:
                traceback.print_exc()
                results.append({"arch": arch, "shape": shape,
                                "error": str(e)[:1000]})
            out.parent.mkdir(exist_ok=True)
            out.write_text(json.dumps(results, indent=1))
    print("analysis probes complete")


if __name__ == "__main__":
    main()
