"""Batched speculative decoding inside the serving engine (counterpart of
localai_tpu/engine/spec.py).

A small draft model proposes gamma tokens for every slot, the target
verifies each slot's [next_token, d_1..d_gamma] window in one forward, and
the Leviathan et al. accept/residual rule keeps the target's sampling
distribution exactly. Each slot emits 1..gamma+1 tokens a step.

The engine carries `next_tokens` [B]: the already-sampled, already-emitted
token whose K/V is not yet written (the first one is sampled at admission,
build_spec_admit_tail). The verify writes its K/V with the drafts'; the
rejected drafts' rows past the new length are dead and the next window
overwrites them.

The target distribution is the slot's full sampling pipeline
(ops/sampling.sampling_probs), token counts frozen at the window start;
the draft proposes from a temperature-only distribution
(ops/sampling.draft_state). Every draw comes from one key split a step and
fold_in domains — drafts 100+i, accept uniforms 1, correction 2 — bit-exact
with the reference's jax.random draws (ops/sampling.fold_in, uniform,
categorical), so one seed gives one token stream in both packages.

These are plain functions on tensors; the caches (and the sampler's token
counts) are updated in place.
"""
from __future__ import annotations

import dataclasses

import torch

from localai_tpu_torch.models.llama import (
    LlamaConfig,
    decode_step,
    extend,
    ragged_forward,
)
from localai_tpu_torch.ops.sampling import (
    SamplerState,
    categorical,
    draft_state,
    fold_in,
    pipeline_logits,
    sample,
    sampling_probs,
    split_keys,
    uniform,
)

TINY = 1e-30


def _draft_phase(params_d, cfg_d: LlamaConfig, gamma: int, cos_d, sin_d, kcd,
                 vcd, sampler, lengths, next_tokens, active, step_keys,
                 gstate=None, gmasks=None, gtrans=None):
    """gamma draft decode steps on the dense draft cache, then the K/V of
    the last draft (on full acceptance its position is committed, and a
    hole there would be attended by every later proposal). Grammar slots
    thread their automaton state and mask each proposal by its row.
    Returns (drafts [B, G] int32, draft probs [B, G, V])."""
    dstate = draft_state(sampler)
    tok, gst = next_tokens, gstate
    drafts, p_ds = [], []
    for i in range(gamma):
        logits_d = decode_step(params_d, cfg_d, tok, lengths + i, cos_d,
                               sin_d, kcd, vcd, active)
        dmask = gmasks[gst.long()] if gmasks is not None else None
        p_d = sampling_probs(logits_d, dstate, dmask)
        tok = categorical(fold_in(step_keys, 100 + i), torch.log(p_d + TINY))
        if gmasks is not None:
            gst = gtrans[gst.long(), tok.long()]
        drafts.append(tok)
        p_ds.append(p_d)
    decode_step(params_d, cfg_d, tok, lengths + gamma, cos_d, sin_d, kcd, vcd,
                active)
    return torch.stack(drafts, dim=1), torch.stack(p_ds, dim=1)


def _verify_outputs(sampler: SamplerState, active, step_keys, carry_keys,
                    d_tok, p_d_stack, tlogits, gamma: int, mask_rows=None):
    """The shared verify tail: the target distribution at every window
    position, the vectorized Leviathan accept, the residual correction
    token, the output assembly and the sampler commit.

    mask_rows: optional [B, G+1, W32] grammar mask words per window
    position (the automaton state after each draft prefix): a masked target
    prob is 0, so a grammar-invalid draft never passes the accept test and
    the residual renormalizes over the allowed set.

    Returns (tokens_out [B, G+1], n_out [B] ungated (= n_extra + 1),
    logprobs_out [B, G+1], c [B] correction token, n_extra [B], sampler')
    with the sampler's token counts updated in place."""
    G = gamma
    B = d_tok.shape[0]
    dev = d_tok.device

    def _m(i):
        return None if mask_rows is None else mask_rows[:, i]

    ps_t = torch.stack([sampling_probs(tlogits[:, i], sampler, _m(i))
                        for i in range(G + 1)], dim=1)          # [B, G+1, V]
    # logprobs under the pre-truncation distribution (sample()'s contract)
    lp_pre = torch.stack(
        [torch.log_softmax(pipeline_logits(tlogits[:, i], sampler, _m(i)),
                           dim=-1) for i in range(G + 1)], dim=1)

    # accept d_i while u_i < p_t(d_i) / p_d(d_i), up to the first reject
    ar = torch.arange(B, device=dev)
    bidx, gidx = ar[:, None], torch.arange(G, device=dev)[None, :]
    dl = d_tok.long()
    pt_d = ps_t[:, :G][bidx, gidx, dl]
    pd_d = p_d_stack[bidx, gidx, dl]
    us = uniform(fold_in(step_keys, 1), G)
    accept = us < pt_d / torch.clamp_min(pd_d, TINY)
    n_extra = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)

    # the correction (or bonus) token from the residual distribution
    p_t_corr = ps_t[ar, n_extra]
    p_d_corr = p_d_stack[ar, torch.clamp_max(n_extra, G - 1)]
    p_d_corr = torch.where((n_extra < G)[:, None], p_d_corr,
                           torch.zeros_like(p_d_corr))
    residual = torch.clamp_min(p_t_corr - p_d_corr, 0.0)
    z = residual.sum(dim=-1, keepdim=True)
    resid = torch.where(z > TINY, residual / torch.clamp_min(z, TINY),
                        p_t_corr)
    c = categorical(fold_in(step_keys, 2), torch.log(resid + TINY))

    # accepted drafts, then the correction token
    cols = torch.arange(G + 1, device=dev)[None, :]
    ne = n_extra[:, None]
    zero = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    d_pad = torch.cat([d_tok.to(torch.int32), zero], dim=1)
    tokens_out = torch.where(cols < ne, d_pad,
                             torch.where(cols == ne, c[:, None], zero))
    n_out = n_extra + 1
    lp_d = lp_pre[:, :G][bidx, gidx, dl]
    lp_d = torch.cat([lp_d, torch.zeros((B, 1), dtype=lp_d.dtype,
                                        device=dev)], dim=1)
    lp_c = lp_pre[ar, n_extra][ar, c.long()]
    logprobs_out = torch.where(
        cols < ne, lp_d,
        torch.where(cols == ne, lp_c[:, None], torch.zeros_like(lp_d)))

    # sampler commit: the emitted tokens of active slots are counted
    valid = (cols < n_out[:, None]) & active[:, None]
    sampler.token_counts.index_put_(
        (bidx.expand(B, G + 1), tokens_out.long()), valid.to(torch.int32),
        accumulate=True)
    sampler = dataclasses.replace(sampler, key=carry_keys)
    return (tokens_out, n_out.to(torch.int32), logprobs_out,
            c, n_extra.to(torch.int32), sampler)


def build_spec_decode(cfg_t: LlamaConfig, cfg_d: LlamaConfig, gamma: int):
    """The all-slots speculative step on a dense or paged target cache:

    (params_t, params_d, cos_t, sin_t, cos_d, sin_d, kct, vct, kcd, vcd,
     sampler, lengths, next_tokens, active, table=None) →
    (tokens_out [B, gamma+1], n_out [B], logprobs_out [B, gamma+1],
     next_tokens', sampler', lengths', n_extra [B])

    The caches are written in place. Inactive slots' verify windows go
    where nothing reads them: on a dense cache to its last row, on a paged
    one to the trash block (extend's redirect)."""

    def spec_decode(params_t, params_d, cos_t, sin_t, cos_d, sin_d, kct,
                    vct, kcd, vcd, sampler, lengths, next_tokens, active,
                    table=None):
        act_i = active.to(torch.int32)
        carry_keys, step_keys = split_keys(sampler.key)
        d_tok, p_d_stack = _draft_phase(
            params_d, cfg_d, gamma, cos_d, sin_d, kcd, vcd, sampler,
            lengths, next_tokens, active, step_keys)
        window = torch.cat([next_tokens[:, None], d_tok], dim=1)
        if table is None:
            # the window of an inactive row starts at the last cache row,
            # which is never read (extend clamps the rest onto it)
            T = kct.shape[3]
            start = torch.where(active, lengths, torch.full_like(lengths,
                                                                 T - 1))
            tlogits = extend(params_t, cfg_t, window, start, cos_t, sin_t,
                             kct, vct)
        else:
            tlogits = extend(params_t, cfg_t, window, lengths, cos_t, sin_t,
                             kct, vct, table=table, redirect=~active)
        (tokens_out, n_out, logprobs_out, c, n_extra,
         sampler) = _verify_outputs(sampler, active, step_keys, carry_keys,
                                    d_tok, p_d_stack, tlogits, gamma)
        lengths = lengths + act_i * (1 + n_extra)
        next_tokens = torch.where(active, c, next_tokens)
        return (tokens_out, n_out * act_i, logprobs_out, next_tokens,
                sampler, lengths, n_extra * act_i)

    return spec_decode


def build_spec_ragged(cfg_t: LlamaConfig, cfg_d: LlamaConfig, gamma: int):
    """The speculative step as a ragged pack: the draft phase as in
    build_spec_decode, the target verify through ragged_forward — each
    verifying slot's window is gamma+1 rows of the flat stream, packed
    beside other slots' prefill chunks in the same dispatch. The drafts
    are spliced into the stream here (they are sampled here), and
    logit_rows [B, gamma+1] gathers the target logits at every window row.
    Grammar slots thread the device tables: each proposal is masked by its
    state's row, and each window position's target probs by the state after
    the draft prefix before it.

    (params_t, params_d, cos_t, sin_t, cos_d, sin_d, kct, vct, kcd, vcd,
     sampler, last_logits, lengths, next_tokens, active, tokens [T],
     spec_rows [B], set_len [B], logit_set [B], logit_rows [B, gamma+1],
     block_seq, qstart, qlen, kvlen, table, inject=None, gstate=None,
     gmasks=None, gtrans=None) →
    (tokens_out, n_out, logprobs_out, next_tokens', sampler',
     last_logits', lengths', n_extra)

    `active` marks the slots verifying a window this tick; spec_rows[b] is
    slot b's window start row; set_len / logit_set carry the packed
    prefill chunks' length commits and final-chunk last_logits updates, as
    in the plain ragged step; `inject` (extra [T, H] f32, is_embed [T]
    bool), a multimodal chunk's feature rows (ragged_forward's inject;
    the draft ingests token ids only)."""

    def spec_ragged(params_t, params_d, cos_t, sin_t, cos_d, sin_d, kct, vct,
                    kcd, vcd, sampler, last_logits, lengths, next_tokens,
                    active, tokens, spec_rows, set_len, logit_set,
                    logit_rows, block_seq, qstart, qlen, kvlen, table,
                    inject=None, gstate=None, gmasks=None, gtrans=None):
        G = gamma
        B = next_tokens.shape[0]
        T = tokens.shape[0]
        dev = tokens.device
        act_i = active.to(torch.int32)
        carry_keys, step_keys = split_keys(sampler.key)
        grammar = gmasks is not None
        d_tok, p_d_stack = _draft_phase(
            params_d, cfg_d, G, cos_d, sin_d, kcd, vcd, sampler, lengths,
            next_tokens, active, step_keys,
            gstate=gstate if grammar else None, gmasks=gmasks, gtrans=gtrans)

        # splice the windows into the stream; inactive slots' rows go to a
        # spare row past the end, which is cut off
        window = torch.cat([next_tokens[:, None], d_tok], dim=1)
        rows = torch.where(
            active[:, None],
            spec_rows.long()[:, None] + torch.arange(G + 1, device=dev)[None],
            torch.full((B, G + 1), T, dtype=torch.int64, device=dev))
        toks = torch.cat([tokens.to(torch.int32),
                          torch.zeros((1,), dtype=torch.int32, device=dev)])
        toks[rows.reshape(-1)] = window.reshape(-1).to(torch.int32)
        toks = toks[:T]

        tlogits = ragged_forward(params_t, cfg_t, toks, cos_t, sin_t, kct,
                                 vct, block_seq, qstart, qlen, kvlen, table,
                                 logit_rows, inject=inject)   # [B, G+1, V]
        # packed final prefill chunks refresh last_logits (their G+1 rows
        # all point at the chunk's last token)
        last_logits = torch.where(logit_set[:, None], tlogits[:, -1],
                                  last_logits)

        mask_rows = None
        if grammar:
            # window[0] is already emitted (gstate is past it): position j
            # masks what may follow window[..j]
            sts = [gstate.long()]
            for j in range(1, G + 1):
                sts.append(gtrans[sts[-1], window[:, j].long()].long())
            mask_rows = gmasks[torch.stack(sts, dim=1)]     # [B, G+1, W32]

        (tokens_out, n_out, logprobs_out, c, n_extra,
         sampler) = _verify_outputs(sampler, active, step_keys, carry_keys,
                                    d_tok, p_d_stack, tlogits, G,
                                    mask_rows=mask_rows)
        # prefill slots commit their packed length; verify slots advance by
        # the accepted run (the sets are disjoint)
        lengths = torch.where(set_len >= 0, set_len.to(lengths.dtype),
                              lengths + act_i * (1 + n_extra))
        next_tokens = torch.where(active, c, next_tokens)
        return (tokens_out, n_out * act_i, logprobs_out, next_tokens,
                sampler, last_logits, lengths, n_extra * act_i)

    return spec_ragged


def build_spec_admit_tail(cfg_t: LlamaConfig):
    """Sample the first token of a freshly admitted slot from its
    last_logits (full pipeline, that slot's key stream only) and count it.
    `mask` is the slot's grammar bitmask [1, ceil(V/8)] u8 (None when
    unconstrained). The slot's key and counts are updated in place.
    Returns (token [], logprob [], sampler)."""

    def admit_tail(sampler: SamplerState, last_logits, slot: int, mask=None):
        row = SamplerState(**{f.name: getattr(sampler, f.name)[slot:slot + 1]
                              for f in dataclasses.fields(SamplerState)})
        tok, keys, lp = sample(last_logits[slot:slot + 1], row, mask)
        sampler.token_counts[slot, tok[0].long()] += 1
        sampler.key[slot] = keys[0]
        return tok[0], lp[0], sampler

    return admit_tail


def build_draft_ingest(cfg_d: LlamaConfig):
    """Write a prompt window into the draft cache (K/V only), beside each
    target admission or chunk write, so the draft never needs a catch-up."""

    def ingest(params_d, cos_d, sin_d, kcd, vcd, tokens, start, slot):
        extend(params_d, cfg_d, tokens, start.reshape(1), cos_d, sin_d, kcd,
               vcd, slot_map=slot.reshape(1), with_logits=False)

    return ingest
