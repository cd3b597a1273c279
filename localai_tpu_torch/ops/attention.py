"""Attention reference implementations in plain PyTorch (counterpart of
localai_tpu/ops/attention.py).

Layouts, as in the reference:
  q:        [B, S, H, D]
  k/v:      [B, S, KVH, D]      (GQA: H % KVH == 0)
  kv cache: [B, KVH, T, D]

Scores and softmax run in float32; the probabilities are cast back to the
query dtype before the value product, as the reference does. On the main
path `mha_extend` (chunked prefill) stays here — the reference uses no
kernel there either; prefill and decode attention go through
ops/kernels/flash_attention.py. The KV lifecycle tier's XLA ops are here
too: `mha_prefill_tiered` (a first chunk under a per-slot sink + window
mask), `mha_extend_tiered` (a chunk against the resident ring view at
true positions) and `mha_decode_masked` (decode under a caller-built row
mask, the core of the tiered paged decode kernel's plain version).
"""
from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _group_query_heads(q, num_kv_heads):
    b, s, h, d = q.shape
    return q.reshape(b, s, num_kv_heads, h // num_kv_heads, d)


def _softcap(logits, cap):
    if cap is None or cap <= 0:
        return logits
    return torch.tanh(logits / cap) * cap


def _common(*xs):
    """Operand dtype of an einsum over mixed dtypes (JAX type promotion:
    f32 with bf16 computes in f32)."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return dt


def mha_prefill(q, k, v, lengths, *, scale=None, softcap=None,
                sliding_window=None):
    """Causal self-attention over padded sequences. lengths: [B] valid
    token count per sequence. Returns [B, S, H, D] in q's dtype."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    dt = _common(q, k)
    qg = _group_query_heads(q, kvh).to(dt)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.to(dt)).float() * scale
    logits = _softcap(logits, softcap)

    pos = torch.arange(s, device=q.device)
    causal = pos[:, None] >= pos[None, :]                      # [S,T]
    valid = pos[None, :] < lengths.to(q.device)[:, None]       # [B,T]
    mask = causal[None, :, :] & valid[:, None, :]              # [B,S,T]
    if sliding_window is not None and sliding_window > 0:
        mask = mask & (pos[:, None] - pos[None, :] < sliding_window)[None]
    logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)

    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    dt = _common(probs, v)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(dt), v.to(dt))
    return out.reshape(b, s, h, d).to(_common(probs, v))


def mha_prefill_tiered(q, k, v, lengths, sinks, window, *, scale=None,
                       softcap=None):
    """mha_prefill with a PER-SLOT attention-sink + sliding-window mask (KV
    lifecycle tier, engine/kvtier.py): the query at position p attends the
    key at position t iff t <= p and (t > p - window[b] or t < sinks[b]).
    Full-policy slots carry sentinel window/sinks >= S and reduce to the
    plain causal mask. sinks/window: [B] int."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    dt = _common(q, k)
    qg = _group_query_heads(q, kvh).to(dt)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.to(dt)).float() * scale
    logits = _softcap(logits, softcap)

    dev = q.device
    pos = torch.arange(s, device=dev)
    causal = pos[:, None] >= pos[None, :]                      # [S,T]
    valid = pos[None, :] < lengths.to(dev)[:, None]            # [B,T]
    mask = causal[None, :, :] & valid[:, None, :]              # [B,S,T]
    win = window.to(dev).long()[:, None, None]
    snk = sinks.to(dev).long()[:, None, None]
    keep = (pos[None, None, :] > pos[None, :, None] - win) \
        | (pos[None, None, :] < snk)
    logits = torch.where((mask & keep)[:, None, None, :, :], logits, NEG_INF)

    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    dt = _common(probs, v)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(dt), v.to(dt))
    return out.reshape(b, s, h, d).to(_common(probs, v))


def mha_extend_tiered(q, k_cache, v_cache, q_positions, kv_positions, kv_ok,
                      sinks, window, *, scale=None, drop_window=True):
    """mha_extend against a RESIDENT (ring-mapped) cache view whose rows
    carry explicit true positions (kv_positions [B, T]) and validity (kv_ok
    [B, T]: residency + freshness, ops/paged.resident_row_positions, plus
    any cold-tier rows the caller concatenated).

    drop_window=True applies the sink_window retention mask per query
    (dropped-block semantics); False keeps every valid row <= the query —
    the quantize_cold case, where exited-window content is still readable
    (at int8) rather than evicted. sinks/window: [B] int."""
    b, s, h, d = q.shape
    kvh = k_cache.shape[1]
    scale = scale if scale is not None else d ** -0.5
    dt = _common(q, k_cache)
    qg = _group_query_heads(q, kvh).to(dt)                      # [B,S,KVH,G,D]
    logits = torch.einsum("bskgd,bktd->bkgst", qg,
                          k_cache.to(dt)).float() * scale

    dev = q.device
    qp = q_positions.to(dev).long()
    kp = kv_positions.to(dev).long()
    mask = kv_ok.to(dev)[:, None, :] & (kp[:, None, :] <= qp[:, :, None])
    if drop_window:
        mask = mask & (
            (kp[:, None, :] > qp[:, :, None]
             - window.to(dev).long()[:, None, None])
            | (kp[:, None, :] < sinks.to(dev).long()[:, None, None]))
    logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)

    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    dt = _common(probs, v_cache)
    out = torch.einsum("bkgst,bktd->bskgd", probs.to(dt), v_cache.to(dt))
    return out.reshape(b, s, h, d)


def mha_decode_masked(q, k_cache, v_cache, kv_mask, *, scale=None,
                      softcap=None):
    """Single-token decode attention with a caller-built row mask [B, T]
    instead of the implicit arange(T) < lengths — the KV lifecycle read
    path, where the cache view is ring-mapped (and optionally concatenated
    with the cold tier) and a row's validity depends on residency, true
    position, window membership and demotion state."""
    b, _, h, d = q.shape
    kvh = k_cache.shape[1]
    scale = scale if scale is not None else d ** -0.5
    dt = _common(q, k_cache)
    qg = _group_query_heads(q, kvh)[:, 0].to(dt)                # [B,KVH,G,D]
    logits = torch.einsum("bkgd,bktd->bkgt", qg,
                          k_cache.to(dt)).float() * scale
    logits = _softcap(logits, softcap)
    logits = torch.where(kv_mask.to(q.device)[:, None, None, :], logits,
                         NEG_INF)

    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    dt = _common(probs, v_cache)
    out = torch.einsum("bkgt,bktd->bkgd", probs.to(dt), v_cache.to(dt))
    return out.reshape(b, 1, h, d)


def mha_extend(q, k_cache, v_cache, q_positions, *, scale=None,
               sliding_window=None):
    """Window attention against the cache: S new tokens whose K/V are
    already written at `q_positions` [B, S]; each query attends to every
    cache entry at position <= its own. caches: [B, KVH, T, D]."""
    b, s, h, d = q.shape
    kvh = k_cache.shape[1]
    t = k_cache.shape[2]
    scale = scale if scale is not None else d ** -0.5
    dt = _common(q, k_cache)
    qg = _group_query_heads(q, kvh).to(dt)
    logits = torch.einsum("bskgd,bktd->bkgst", qg,
                          k_cache.to(dt)).float() * scale

    pos = torch.arange(t, device=q.device)
    qp = q_positions.to(q.device)
    mask = pos[None, None, :] <= qp[:, :, None]                 # [B,S,T]
    if sliding_window is not None and sliding_window > 0:
        mask = mask & (pos[None, None, :] > qp[:, :, None] - sliding_window)
    logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)

    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    dt = _common(probs, v_cache)
    out = torch.einsum("bkgst,bktd->bskgd", probs.to(dt), v_cache.to(dt))
    return out.reshape(b, s, h, d)


def mha_decode(q, k_cache, v_cache, lengths, *, scale=None, softcap=None,
               sliding_window=None):
    """Single-token decode attention. q: [B, 1, H, D]; caches [B, KVH, T,
    D]; lengths: [B] valid entries INCLUDING the token being decoded."""
    b, _, h, d = q.shape
    kvh = k_cache.shape[1]
    t = k_cache.shape[2]
    scale = scale if scale is not None else d ** -0.5
    dt = _common(q, k_cache)
    qg = _group_query_heads(q, kvh)[:, 0].to(dt)                # [B,KVH,G,D]
    logits = torch.einsum("bkgd,bktd->bkgt", qg,
                          k_cache.to(dt)).float() * scale
    logits = _softcap(logits, softcap)

    pos = torch.arange(t, device=q.device)
    ln = lengths.to(q.device)
    mask = pos[None, :] < ln[:, None]                           # [B,T]
    if sliding_window is not None and sliding_window > 0:
        mask = mask & (pos[None, :] >= ln[:, None] - sliding_window)
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)

    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    dt = _common(probs, v_cache)
    out = torch.einsum("bkgt,bktd->bkgd", probs.to(dt), v_cache.to(dt))
    return out.reshape(b, 1, h, d)
