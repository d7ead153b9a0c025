"""Channel-permutation clustering for group sparsity.

Port of `teal_tpu/calibration/permute.py`: the permutation search is host
numpy, as there; the captures run on the params' device (`grab_acts`),
and `apply_permutations` folds the permutations into the torch
parameters on that device.

Group-granular sparsity drops whole G-channel groups; its quality depends
on how COHERENT groups are (a group containing one always-hot channel and
15 cold ones can never be dropped without error). Real LLMs have strongly
heterogeneous channel magnitudes (massive-activation channels), so sorting
channels by calibrated magnitude before grouping clusters hot channels
together and makes group selection approach unstructured quality.

Every permutation FOLDS INTO THE WEIGHTS offline — zero runtime cost:

  - residual-stream channels (the h1 inputs of q/k/v/gate/up): ONE global
    permutation applied to embed columns, norm weights, projection input
    rows, o/down output columns and lm_head rows — the residual stream
    simply lives permuted;
  - per-layer MLP intermediate channels (down's input): permute gate/up
    output columns and down input rows;
  - per-layer attention-output channels (o's input): permute v output
    columns within each KV head (RoPE and the attention math never see
    it) and o's input rows to match.

All three are exact re-parameterizations (tested: permuted model output ==
original up to fp reduction order); only the channel GROUPING that block
sparsity sees changes.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from teal_tpu_torch.config import ModelConfig


def channel_stats(values: np.ndarray) -> np.ndarray:
    """Per-channel mean |x| over all positions. values: [..., D] -> [D]."""
    v = np.abs(np.asarray(values, np.float32))
    return v.reshape(-1, v.shape[-1]).mean(axis=0)


def sort_perm(stats: np.ndarray) -> np.ndarray:
    """Channels ordered by descending magnitude (hot channels first, so
    cold channels cluster into droppable groups)."""
    return np.argsort(-np.asarray(stats), kind="stable").astype(np.int32)


def coactivation_perm(
    values: np.ndarray,
    G: int,
    sparsity: float = 0.5,
    max_positions: int = 2048,
    mag_weight: float = 0.05,
) -> np.ndarray:
    """Channels clustered into G-sized groups by KEEP-DECISION correlation.

    Magnitude sorting only exploits scale heterogeneity; on real LLM h1
    hidden states the inner-bulk channel scales are nearly homogeneous
    (sigma ~ 0.1-0.4 estimated from the reference's shipped histograms —
    experiments/real_heterogeneity.py), where group selection is weakest.
    What magnitude cannot see is PER-TOKEN structure: channels that fire
    together. If a group's channels co-activate, the per-position group
    score tracks a real on/off signal and group selection approaches
    elementwise quality (contextual-sparsity literature: neuron
    co-firing, e.g. Deja Vu). This clusters channels greedily: seed each
    group with the most-active unassigned channel, then add the G-1
    unassigned channels whose z-scored keep-decision vectors correlate
    best with the seed's (tie-broken toward similar magnitude, so with
    zero correlation structure it degrades to magnitude clustering).

    values: [..., D] calibration activations for ONE hidden type.
    Returns a [D] permutation (group g = channels [g*G:(g+1)*G]).
    """
    X = np.abs(np.asarray(values, np.float32)).reshape(-1, values.shape[-1])
    P, D = X.shape
    if P > max_positions:
        step = P // max_positions
        X = X[:: step][:max_positions]
        P = X.shape[0]
    t = np.quantile(X, sparsity)
    B = (X > t).astype(np.float32)
    mu = B.mean(axis=0)
    sd = B.std(axis=0) + 1e-6
    Z = (B - mu) / (sd * np.sqrt(P))       # corr(i,j) = Z[:,i] @ Z[:,j]
    act = X.mean(axis=0)
    log_act = np.log(act + 1e-12)
    seed_order = np.argsort(-act, kind="stable")

    assigned = np.zeros(D, bool)
    perm = np.empty(D, np.int32)
    pos = 0
    si = 0
    n_groups = D // G
    for _ in range(n_groups):
        while assigned[seed_order[si]]:
            si += 1
        seed = int(seed_order[si])
        corr = Z[:, seed] @ Z
        # significance floor: sample correlations of truly-independent
        # channels scatter ~1/sqrt(P); below 2 sigma they are noise and
        # grouping by them is WORSE than magnitude clustering — zero
        # them so the magnitude term decides (graceful degradation to
        # ~magnitude sorting on structure-free activations)
        corr[np.abs(corr) < 2.0 / np.sqrt(P)] = 0.0
        sims = corr - mag_weight * np.abs(log_act - log_act[seed])
        sims[assigned] = -np.inf
        sims[seed] = np.inf
        members = np.argpartition(-sims, G - 1)[:G]
        members = members[np.argsort(-sims[members], kind="stable")]
        perm[pos:pos + G] = members
        assigned[members] = True
        pos += G
    if pos < D:                             # D % G remainder (shouldn't
        perm[pos:] = np.flatnonzero(~assigned)   # happen for model dims)
    return perm


def group_dropped_energy(values: np.ndarray, perm: np.ndarray, G: int,
                         sparsity: float) -> float:
    """Energy fraction dropped by top-k group selection under `perm`."""
    X = np.asarray(values, np.float32).reshape(-1, values.shape[-1])
    xp = X[:, perm]
    P, D = xp.shape
    nb = D // G
    sc = np.abs(xp[:, : nb * G]).reshape(P, nb, G).max(-1)
    k = max(1, int(round(nb * (1.0 - sparsity))))
    kth = np.sort(sc, axis=1)[:, nb - k][:, None]
    mask = np.repeat(sc >= kth, G, axis=1)
    e_tot = float((xp.astype(np.float64) ** 2).sum()) + 1e-30
    kept = np.where(mask, xp[:, : nb * G], 0.0)
    return 1.0 - float((kept.astype(np.float64) ** 2).sum()) / e_tot


def _calibrated_perm(values: np.ndarray, G: int, sparsity: float,
                     method: str) -> np.ndarray:
    """One hidden-type permutation. For "coactivation", both candidates
    (magnitude sort and co-activation clusters) are built on the first
    half of the positions and scored by group-selection dropped energy
    on the held-out second half — the winner ships, so the method can
    never lose to magnitude sorting beyond eval noise."""
    flat = np.asarray(values, np.float32).reshape(-1, values.shape[-1])
    if method == "magnitude" or flat.shape[0] < 64:
        return sort_perm(channel_stats(flat))
    half = flat.shape[0] // 2
    cands = [sort_perm(channel_stats(flat[:half])),
             coactivation_perm(flat[:half], G, sparsity)]
    drops = [group_dropped_energy(flat[half:], p, G, sparsity)
             for p in cands]
    return cands[int(np.argmin(drops))]


def _host(x: torch.Tensor) -> np.ndarray:
    """A capture as a float32 host array."""
    return x.float().cpu().numpy()


def compute_permutations(
    params,
    cfg: ModelConfig,
    tokens,
    *,
    method: str = "magnitude",
    block_size: int = 128,
    sparsity: float = 0.5,
) -> Dict:
    """Calibrate all permutations from a token batch (uses the capture
    pipeline's per-layer hidden groups).

    method: "magnitude" (sort by calibrated mean |x|) or "coactivation"
    (G-sized keep-decision-correlation clusters, `coactivation_perm` —
    targets the per-token structure magnitude sorting cannot see).

    Returns {"residual": [D], "inter": [L][I], "kv": [L][Hkv, Dh]}.
    """
    from teal_tpu_torch.calibration.grab_acts import (_embed, _layer_capture,
                                                      _layer_params)
    from teal_tpu_torch.ops.block_gemv import effective_block_size

    if method not in ("magnitude", "coactivation"):
        raise ValueError(f"unknown permutation method {method!r}")
    hidden = _embed(params, tokens)

    g = cfg.n_heads // cfg.n_kv_heads
    d = cfg.head_dim
    coact = method == "coactivation"
    g_res = effective_block_size(block_size, cfg.dim)
    g_int = effective_block_size(block_size, cfg.intermediate_size)
    resid_stats = np.zeros(cfg.dim, np.float64)
    resid_rows: List[np.ndarray] = []   # subsampled h1 rows (coactivation)
    inter_perms: List[np.ndarray] = []
    kv_perms: List[np.ndarray] = []
    for l in range(cfg.n_layers):
        hidden, caps = _layer_capture(_layer_params(params, l), hidden, cfg)
        h1a = _host(caps["self_attn"]["h1"])
        h1m = _host(caps["mlp"]["h1"])
        resid_stats += channel_stats(h1a)
        resid_stats += channel_stats(h1m)
        if coact:
            per = max(1, 128 // max(cfg.n_layers // 16, 1))
            for arr in (h1a, h1m):
                flat = arr.reshape(-1, cfg.dim)
                step = max(1, flat.shape[0] // per)
                resid_rows.append(flat[::step][:per])
        h2m = caps["mlp"].get("h2")
        if h2m is not None:
            inter_perms.append(_calibrated_perm(
                _host(h2m), g_int, sparsity, method))
        else:   # MoE: experts run dense, no shared mlp h2 — identity
            inter_perms.append(
                np.arange(cfg.intermediate_size, dtype=np.int32))
        # attn-out [Hq*Dh]; per-KV-head perms (RoPE/attention constraint:
        # channels only move WITHIN their KV head). Groups of the o
        # projection input span min(G_o, head_dim) channels, so cluster
        # at that size inside each head.
        h2a = _host(caps["self_attn"]["h2"])
        st = channel_stats(h2a)
        st_kv = st.reshape(cfg.n_kv_heads, g, d).mean(axis=1)     # [Hkv, d]
        g_o = min(effective_block_size(block_size, cfg.n_heads * d), d)
        if coact and g_o < d:
            # fold q-heads sharing a KV head into extra positions
            v = h2a.reshape(-1, cfg.n_kv_heads, g, d)
            kv_perms.append(np.stack([
                _calibrated_perm(
                    v[:, h].reshape(-1, d), g_o, sparsity, method)
                for h in range(cfg.n_kv_heads)
            ]).astype(np.int32))
        else:
            kv_perms.append(np.stack(
                [np.argsort(-st_kv[h], kind="stable")
                 for h in range(cfg.n_kv_heads)]
            ).astype(np.int32))
    if coact:
        res_vals = np.concatenate(resid_rows, axis=0)
        residual = _calibrated_perm(res_vals, g_res, sparsity, method)
    else:
        residual = sort_perm(resid_stats)
    return {
        "residual": residual,
        "inter": inter_perms,
        "kv": kv_perms,
    }


def _attn_out_perm(kv_perm: np.ndarray, cfg: ModelConfig) -> np.ndarray:
    """Expand per-KV-head channel perms to the [Hq*Dh] attn-out layout."""
    g = cfg.n_heads // cfg.n_kv_heads
    d = cfg.head_dim
    full = np.empty(cfg.n_heads * d, np.int32)
    for qh in range(cfg.n_heads):
        full[qh * d:(qh + 1) * d] = qh * d + kv_perm[qh // g]
    return full


def _kv_out_perm(kv_perm: np.ndarray, cfg: ModelConfig) -> np.ndarray:
    """Per-KV-head perms in the [Hkv*Dh] v-projection output layout."""
    d = cfg.head_dim
    return np.concatenate(
        [h * d + kv_perm[h] for h in range(cfg.n_kv_heads)]
    ).astype(np.int32)


def apply_permutations(params, perms: Dict, cfg: ModelConfig):
    """New params tree with all permutations folded into the weights, on
    the params' device."""
    dev = params["embed"].device

    def idx(p) -> torch.Tensor:
        return torch.as_tensor(np.asarray(p), dtype=torch.int64, device=dev)

    P = idx(perms["residual"])
    lay = params["layers"]

    out = {
        "attn_norm": lay["attn_norm"][:, P],
        "mlp_norm": lay["mlp_norm"][:, P],
        "wq": lay["wq"][:, P, :],
        "wk": lay["wk"][:, P, :],
    }
    wv_l, wo_l, wg_l, wu_l, wd_l = [], [], [], [], []
    for l in range(cfg.n_layers):
        Q = idx(perms["inter"][l])
        R_full = idx(_attn_out_perm(perms["kv"][l], cfg))
        R_kv = idx(_kv_out_perm(perms["kv"][l], cfg))
        wv_l.append(lay["wv"][l][P][:, R_kv])
        wo_l.append(lay["wo"][l][:, P][R_full])
        wg_l.append(lay["wgate"][l][P][:, Q])
        wu_l.append(lay["wup"][l][P][:, Q])
        wd_l.append(lay["wdown"][l][:, P][Q])
    out["wv"] = torch.stack(wv_l)
    out["wo"] = torch.stack(wo_l)
    out["wgate"] = torch.stack(wg_l)
    out["wup"] = torch.stack(wu_l)
    out["wdown"] = torch.stack(wd_l)

    return {
        "embed": params["embed"][:, P],
        "layers": out,
        "final_norm": params["final_norm"][P],
        "lm_head": params["lm_head"][P, :],
    }
