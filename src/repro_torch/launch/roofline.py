"""Roofline analysis over dry-run artifacts, with the H100's constants.

Reads dry-run artifacts in the reference's format (``*.json`` under
``--dir``, default ``experiments/dryrun``, which it only reads) and
derives the three roofline terms per (arch x shape x impl) cell:

    compute    = FLOPs_per_chip / 67 TFLOP/s     (f32 peak)
    memory     = bytes_per_chip / 3.35 TB/s      (HBM3)
    collective = collective_bytes_per_chip / 450 GB/s  (NVLink 4, per
                 direction)

all of an NVIDIA H100 80GB HBM3 at 700 W. The compute peak is the f32
one because the port's circulant kernels, attention and loss logits
compute in f32; bf16 tensor-core GEMMs would see ~989 TFLOP/s dense. The
analytic terms (``launch.analytic.cell_model``) are primary; an artifact's
recorded ones are used when present. MODEL_FLOPS is 6·N·D (train) /
2·N·D (prefill/decode) with N = active stored params, so MODEL_FLOPS over
the analytic FLOPs surfaces remat recompute, transform overhead (the SWM
FFT/DFT work) and capacity-padding waste.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.roofline \
        [--dir experiments/dryrun] [--json-out experiments/dryrun_torch/roofline.json]
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
from typing import Dict, List

__all__ = ["PEAK", "HBM", "LINK", "HINTS", "bc_flops", "load", "analyse",
           "fmt_md", "main"]

PEAK = 67e12       # f32 FLOP/s; NVIDIA H100 80GB HBM3, 700 W
HBM = 3.35e12      # B/s HBM3; NVIDIA H100 80GB HBM3, 700 W
LINK = 450e9       # B/s NVLink 4 per direction; NVIDIA H100 80GB HBM3, 700 W

HINTS = {
    "compute": ("cut transform overhead: fuse wi/wu forward DFTs, larger "
                "block k, Karatsuba complex product, per-bin products on "
                "wgmma tensor cores in the hand-written kernels"),
    "memory": ("cut HBM traffic: keep frequency-domain tiles in shared "
               "memory, stage tables with TMA, bf16 intermediates, keep "
               "frozen FFT(w) resident"),
    "collective": ("cut NCCL traffic: bucket and overlap the DP all-reduce "
                   "with the backward, int8 gradient compression, keep the "
                   "ranks of a collective on one NVLink domain"),
}


def bc_flops(rows: int, p: int, q: int, k: int, groups: int = 1,
             inverse: int = None) -> float:
    """FLOPs of one block-circulant kernel call over ``rows`` rows (and
    ``groups`` groups) of a ``(p, q)`` table at block size ``k``: an FFT's
    2.5·k·log2(k) per real transform, ``rows`` of them per input and per
    output block (``bc_matmul``: q forward and p inverse per row; the
    weight adjoint ``bc_dw``: q and p forward per row), plus the 8·p·q·K
    per-bin complex products per row (K = k/2 + 1). ``inverse`` adds that
    many transforms once per call (``bc_dw``'s P·Q inverse transforms of
    its time-domain output)."""
    fft = 2.5 * k * math.log2(k)
    per_row = fft * (p + q) + 8 * p * q * (k // 2 + 1)
    return groups * (rows * per_row + fft * (inverse or 0))


def load(dir_: str) -> List[dict]:
    rows = []
    for p in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(p) as f:
            r = json.load(f)
        r["_file"] = os.path.basename(p)
        rows.append(r)
    return rows


_PCACHE: Dict[str, dict] = {}


def _params_info(arch: str) -> dict:
    """flops_n / embed breakdown (recomputed live — older artifacts lack it)."""
    if arch not in _PCACHE:
        from repro_torch.configs.registry import get_config
        from repro_torch.launch.specs import count_params
        _PCACHE[arch] = count_params(get_config(arch))
    return _PCACHE[arch]


def _analytic(r: dict) -> dict:
    """Prefer recorded analytic terms; recompute live for older artifacts
    (pure math — no compilation)."""
    if "analytic" in r:
        return r["analytic"]
    import dataclasses as dc
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.analytic import cell_model
    cfg = get_config(r["arch"])
    impl = r.get("impl")
    if impl and impl != "dense":
        cfg = dc.replace(cfg, swm=dc.replace(cfg.swm, impl=impl))
    elif impl == "dense":
        cfg = dc.replace(cfg, swm=dc.replace(cfg.swm, block_size=0))
    return cell_model(cfg, SHAPES[r["shape"]], chips=r.get("devices", 256))


def analyse(r: dict) -> dict:
    if "error" in r or "flops" not in r:
        return {**r, "status": "FAIL" if "error" in r else "PARTIAL"}
    a = _analytic(r)
    # primary terms: the structural model (XLA cost_analysis counts while
    # bodies once — see launch/analytic.py docstring); artifact terms kept
    # as secondary columns.
    t_c = a["a_flops_per_chip"] / PEAK
    t_m = a["a_bytes_per_chip"] / HBM
    t_x = a["a_coll_per_chip"] / LINK
    coll_w = r.get("collective_bytes_weighted")
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    dominant = max(terms, key=terms.get)
    # artifact (secondary)
    flops = r["flops"]
    h_c = flops / PEAK
    h_m = r.get("bytes_accessed", 0.0) / HBM
    h_x = sum(r.get("collective_bytes", {}).values()) / LINK
    # MODEL_FLOPS (global): 6·N·D train, 2·N·D serve; N excludes embedding
    # gathers but includes the vocab head (launch.specs.count_params).
    pinfo = r.get("params") or {}
    if "flops_n" not in pinfo:
        try:
            pinfo = _params_info(r["arch"])
        except (KeyError, ImportError, AttributeError):
            # unknown arch in an old artifact, or a registry module that
            # moved since the dryrun was recorded — report zero MODEL_FLOPS
            # rather than refusing to summarize the rest of the cell
            pinfo = {"flops_n": 0, "stored": 0}
    from repro_torch.configs.base import SHAPES
    shape = SHAPES[r["shape"]]
    kind = r.get("kind", shape.kind)
    tokens = r.get("tokens") or (
        shape.global_batch * shape.seq_len if kind != "decode"
        else shape.global_batch)
    body_n = pinfo.get("body_n", pinfo.get("flops_n", 0))
    head_n = pinfo.get("head_n", 0)
    head_tokens = tokens if kind == "train" else shape.global_batch
    mult = 6 if kind == "train" else 2
    model_flops = mult * (body_n * tokens + head_n * head_tokens)
    chips = r.get("devices", 256)
    ratio = model_flops / max(a["a_flops"], 1.0)
    # Ideal time = the unavoidable cost under EITHER resource: MODEL_FLOPS
    # at the compute peak, or the minimal byte stream (weights once per TP shard +
    # KV once) at full HBM bandwidth.
    ideal_c = model_flops / (chips * PEAK)
    ideal_m = a.get("a_min_bytes_per_chip", 0) / HBM
    ideal = max(ideal_c, ideal_m)
    frac = ideal / max(max(terms.values()), 1e-30)
    return {
        **r,
        "status": "OK",
        "t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_x,
        "hlo_t_compute_s": h_c, "hlo_t_memory_s": h_m,
        "hlo_t_collective_s": h_x,
        "hlo_w_collective_s": (sum(coll_w.values()) / LINK) if coll_w else None,
        "dominant": dominant,
        "model_flops": model_flops,
        "ideal_s": ideal,
        "useful_ratio": ratio,
        "roofline_fraction": frac,
        "hint": HINTS[dominant],
    }


def fmt_md(rows: List[dict], mesh: str = "single") -> str:
    out = ["| arch | shape | impl | compute s | memory s | collective s |"
           " dominant | MODEL_FLOPS | useful | roofline frac |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("mesh") != mesh:
            continue
        if r.get("status") != "OK":
            out.append(f"| {r.get('arch')} | {r.get('shape')} | "
                       f"{r.get('impl','?')} | — | — | — | "
                       f"{r.get('status')}: {r.get('error','')[:60]} | | |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['impl']} "
            f"| {r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} "
            f"| {r['t_collective_s']:.3e} | **{r['dominant']}** "
            f"| {r['model_flops']:.2e} | {r['useful_ratio']:.3f} "
            f"| {r['roofline_fraction']:.3f} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--json-out",
                    default="experiments/dryrun_torch/roofline.json")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)
    rows = [analyse(r) for r in load(args.dir)]
    os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
    with open(args.json_out, "w") as f:
        json.dump(rows, f, indent=1, default=str)
    print(fmt_md(rows, args.mesh))


if __name__ == "__main__":
    main()
