"""Whole-model GPTQ: layer-streaming calibration + per-projection GPTQ.

Port of `teal_tpu/calibration/gptq_runner.py`, on the params' device. The
capture pipeline (`grab_acts._layer_capture`, its attention through
kernel K6 at S >= 256) provides each projection's true input
distribution (q/k/v <- attn h1, o <- attn h2, gate/up <- mlp h1, down <-
mlp h2 — the same four groups TEAL calibrates thresholds on), and
`ops.gptq` does the column-wise compensation in float64 on the same
device. Output is an int4 params tree (`{"q","scale","zero"}` dicts) that
runs through the model's int4 paths (`quant.pack_int4_params` for the
decode kernels).

Propagation is block-sequential by default, matching the reference's
propagation granularity (`gpt-fast/GPTQ.py` runs each traced module on the
quantized prefix): after layer l's projections are quantized, the
layer's output is recomputed with the DEQUANTIZED weights, so layer l+1
calibrates on the activations it will see at inference.
`intra_block=True` additionally sub-sequences WITHIN a block in dataflow
order: q/k/v calibrate on the block input, then wo on the attention
output computed with the QUANTIZED q/k/v, then gate/up, then wdown —
five forwards per layer instead of two. `sequential=False` is the
one-shot variant (one forward per layer; every layer sees full-precision
activations).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from teal_tpu_torch.config import ModelConfig
from teal_tpu_torch.calibration.grab_acts import (_embed, _layer_capture,
                                                  _layer_params)
from teal_tpu_torch.ops.gptq import gptq_quantize_int4
from teal_tpu_torch.ops.quant import dequantize_int4

_PROJ_INPUT = {
    "wq": ("self_attn", "h1"),
    "wk": ("self_attn", "h1"),
    "wv": ("self_attn", "h1"),
    "wo": ("self_attn", "h2"),
    "wgate": ("mlp", "h1"),
    "wup": ("mlp", "h1"),
    "wdown": ("mlp", "h2"),
}


def _fit_group(K: int, group: int) -> int:
    for g in range(min(group, K), 0, -1):
        if K % g == 0:
            return g
    return 1


def gptq_quantize_model(
    params,
    cfg: ModelConfig,
    tokens,
    *,
    group: int = 128,
    percdamp: float = 0.01,
    sequential: bool = True,
    intra_block: bool = False,
    progress: bool = False,
    on_projection: Optional[Callable] = None,
) -> Dict:
    """Returns a params tree with the seven projections as int4 dicts
    ({"q": int8 [L, K, N], "scale", "zero": fp32 [L, K/g, N]}) on the
    params' device; the rest of the tree is shared with `params`.

    tokens: [B, S] integer array, the calibration batch.
    sequential: propagate each layer's output through the QUANTIZED
    weights (reference behavior). False = one-shot (full-precision
    propagation; one forward per layer instead of two).
    intra_block: also sub-sequence WITHIN each block (implies
    sequential): qkv -> o -> gate/up -> down, each stage calibrated on
    intermediates recomputed with the earlier stages' quantized weights.
    on_projection: called as on_projection(layer, name, w, x, wq) after
    each projection is quantized: its weights [K, N], the input it was
    calibrated on [T, K] and its `Int4Weight`.
    """
    if intra_block and not sequential:
        raise ValueError("intra_block GPTQ requires sequential=True")
    dtype = params["layers"]["wq"].dtype
    hidden = _embed(params, tokens)

    # intra-block stages in dataflow order: each stage's projections
    # share one calibration capture taken AFTER the previous stage's
    # quantized weights were installed
    stages = (
        (("wq", "wk", "wv"), ("wo",), ("wgate", "wup"), ("wdown",))
        if intra_block
        else (tuple(_PROJ_INPUT),)
    )

    per_layer: Dict[str, list] = {k: [] for k in _PROJ_INPUT}
    for l in range(cfg.n_layers):
        lp = _layer_params(params, l)
        lq = dict(lp)
        for stage in stages:
            h_out, caps = _layer_capture(lq, hidden, cfg)
            for name in stage:
                module, htype = _PROJ_INPUT[name]
                w = lp[name]
                x = caps[module][htype].reshape(-1, w.shape[0])
                g = _fit_group(w.shape[0], group)
                wq = gptq_quantize_int4(w, x, group=g, percdamp=percdamp)
                per_layer[name].append(wq)
                if on_projection is not None:
                    on_projection(l, name, w, x, wq)
                if sequential:
                    lq[name] = dequantize_int4(wq, dtype)
            del caps
        if sequential:
            # re-run the layer on the quantized weights so the next
            # layer's Hessian sees the accumulated quantization error
            h_out, _ = _layer_capture(lq, hidden, cfg)
        hidden = h_out
        if progress:
            print(f"gptq layer {l}/{cfg.n_layers}", flush=True)

    out = {k: v for k, v in params.items() if k != "layers"}
    layers = {}
    for name, stack in params["layers"].items():
        if name in per_layer:
            layers[name] = {
                key: torch.stack([getattr(w, key) for w in per_layer[name]])
                for key in ("q", "scale", "zero")}
        else:
            layers[name] = stack
    out["layers"] = layers
    return out
