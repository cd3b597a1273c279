"""Embeddings and rerank runners over the decoder (counterpart of
localai_tpu/engine/embedder.py).

`Embedder` pads prompts to a small set of length buckets and the batch to
a power of two, as the reference does (there, so each shape compiles
once; here the shapes stay the reference's, so a request's padding and
its errors are the same), and returns masked-mean pooled, L2-normalized
f32 vectors (models/llama.encode_pooled). `CrossScorer` scores each
document by the model's mean log-probability of the document tokens
given the query prefix (models/llama.forward_train): query and document
attend jointly, a cross-encoder over the causal LM. Both run on the
device the params live on, through flash_prefill (row 1) and the weight
GEMMs (rows 13 / 14); neither writes a KV cache.
"""
from __future__ import annotations

import numpy as np
import torch

from localai_tpu_torch import not_ported
from localai_tpu_torch.device import resolve_device
from localai_tpu_torch.models.llama import (
    LlamaConfig, encode_pooled, forward_train,
)


def _buckets(buckets, top: int) -> tuple[int, ...]:
    return tuple(sorted(b for b in buckets if b <= top)) or (64,)


def _pad_batch(n: int) -> int:
    """The batch padded to a power of two (the reference's compile-once
    rule; kept so a request's padding is the same)."""
    nb = 1
    while nb < n:
        nb *= 2
    return nb


class Embedder:
    """[N] token-id lists → [N, H] f32 L2-normalized embeddings. `device`:
    where the inputs go (default: the card; the params must live there)."""

    def __init__(self, cfg: LlamaConfig, params, *,
                 buckets: tuple[int, ...] = (64, 256, 1024), mesh=None,
                 device=None):
        if mesh is not None:
            raise not_ported("embeddings under a mesh", "parallel")
        self.cfg = cfg
        self.params = params
        self.buckets = _buckets(buckets, cfg.max_position)
        self.device = resolve_device(device)
        self._fn = encode_pooled

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"input length {n} exceeds max embedding bucket "
            f"{self.buckets[-1]}")

    def embed(self, ids_batch: list[list[int]]) -> np.ndarray:
        """[N] token-id lists → [N, H] f32 L2-normalized embeddings."""
        if not ids_batch:
            return np.zeros((0, self.cfg.hidden_size), np.float32)
        n = len(ids_batch)
        longest = max(len(ids) for ids in ids_batch)
        bucket = self._bucket(max(longest, 1))
        nb = _pad_batch(n)
        toks = np.zeros((nb, bucket), np.int32)
        lens = np.zeros((nb,), np.int32)
        for i, ids in enumerate(ids_batch):
            toks[i, : len(ids)] = ids
            lens[i] = len(ids)
        with torch.no_grad():
            out = self._fn(self.params, self.cfg,
                           torch.from_numpy(toks).to(self.device),
                           torch.from_numpy(lens).to(self.device))
            return out[:n].cpu().numpy()


def _doc_logprob(params, cfg: LlamaConfig, tokens, lengths, q_len):
    """Mean conditional log-prob of the document tokens given the query
    prefix. tokens [B, S]; lengths [B] total (query + document); q_len
    [B]. log_softmax runs in f32 over [B, S, V]; the logits and the
    log-probs are freed as soon as the document rows are gathered."""
    logits = forward_train(params, cfg, tokens)             # [B, S, V]
    lp = torch.log_softmax(logits.float(), dim=-1)
    del logits
    s = tokens.shape[1]
    # position i's logits predict token i + 1
    tok_lp = lp[:, :-1].gather(-1, tokens[:, 1:, None].long())[..., 0]
    del lp
    pos = torch.arange(s - 1, device=tokens.device)[None, :]
    mask = ((pos + 1 >= q_len[:, None]) & (pos + 1 < lengths[:, None]))
    n_doc = torch.clamp_min(mask.sum(dim=1), 1)
    return (tok_lp * mask).sum(dim=1) / n_doc


class CrossScorer:
    """Cross-encoder-style reranker over the causal LM: each document is
    scored by the model's mean log-likelihood of its tokens CONDITIONED on
    the query, query and document in one sequence (the reference's rerank
    role). `device` as Embedder's."""

    def __init__(self, cfg: LlamaConfig, params, *,
                 buckets: tuple[int, ...] = (64, 256, 1024), mesh=None,
                 device=None):
        if mesh is not None:
            raise not_ported("rerank under a mesh", "parallel")
        self.cfg = cfg
        self.params = params
        self.buckets = _buckets(buckets, cfg.max_position)
        self.device = resolve_device(device)

    def score(self, query_ids: list[int],
              docs_ids: list[list[int]]) -> np.ndarray:
        """[N] relevance scores (higher = more relevant)."""
        if not docs_ids:
            return np.zeros((0,), np.float32)
        pairs = [list(query_ids) + list(d) for d in docs_ids]
        longest = max(len(p) for p in pairs)
        bucket = next((b for b in self.buckets if longest <= b), None)
        if bucket is None:
            raise ValueError(
                f"query+document length {longest} exceeds max bucket "
                f"{self.buckets[-1]}")
        n = len(pairs)
        nb = _pad_batch(n)
        toks = np.zeros((nb, bucket), np.int32)
        lens = np.zeros((nb,), np.int32)
        for i, p in enumerate(pairs):
            toks[i, :len(p)] = p
            lens[i] = len(p)
        qlen = np.full((nb,), len(query_ids), np.int32)
        dev = self.device
        with torch.no_grad():
            out = _doc_logprob(self.params, self.cfg,
                               torch.from_numpy(toks).to(dev),
                               torch.from_numpy(lens).to(dev),
                               torch.from_numpy(qlen).to(dev))
            return out[:n].cpu().numpy()
