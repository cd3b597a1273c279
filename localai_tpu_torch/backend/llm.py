"""The LLM backend servicer (counterpart of localai_tpu/backend/llm.py),
main-path slice: LoadModel reads an HF safetensors checkpoint onto the
device, Predict/PredictStream drive the continuous-batching Engine,
TokenizeString, Status, GetMetrics and Health answer as the reference's
do; `kv_pages` selects the paged KV pool. `PredictOptions.grammar` (a GBNF
string: tool calls, `response_format` JSON) constrains a request's
tokens; a malformed grammar is INVALID_ARGUMENT for that request alone.
`draft_model` (a checkpoint directory, resolved against `model_path`) and
`n_draft` serve speculative decoding: the draft proposes n_draft tokens a
step (4 by default) and GetMetrics carries draft_proposed and
draft_accepted. `kv_host_bytes` in `options` turns on the host KV spill
tier, `kv_policy` and `kv_cold_pages` the KV retention tier (GetMetrics
then carries kv_cold_blocks, kv_evictions, kv_recomputes and
kv_policy_demotions); `resume_json` (a ResumeToken) continues a preempted
stream, and `preempt` (the SIGTERM path of server.py) ends every open
stream with a terminal "preempted" reply carrying one.
`mesh_model=N` serves the model tensor-parallel over N ranks on this
host: LoadModel starts ranks 1..N-1 as worker processes (core/worker.py,
rank r on cuda:r % device_count, or the CPU), joins them as rank 0 over
torch.distributed (parallel/distributed.py) and serves the rank-0
engine, which broadcasts every dispatch to them; `free()` (and shutdown)
stops them and keeps their output (`follower_output`). Tensor
parallelism is opt-in: with no `mesh_model` the model loads on one card
however many are visible (the reference's auto-TP waits until a mesh
serves all that one card serves).
The other roles of the reference's servicer: `embeddings=true` builds an
Embedder (masked-mean pooled vectors, `Embedding`) and a CrossScorer
(`Rerank`: each document's mean log-probability given the query) beside
the engine (engine/embedder.py); a BERT-family directory loads the
encoder alone (models/bert.py), serving `Embedding` and `TokenizeString`
with the generation RPCs FAILED_PRECONDITION; a llava directory loads
its CLIP tower and projector beside the engine (models/llava.py), and
Predict/PredictStream `images` (base64, or data: URLs) become injected
feature rows of the prompt (GenRequest.mm_embeds). Under `mesh_model >
1` these roles fail the load, and `mesh_data`, `audios` and telemetry
spans wait for later slices, each naming its slice.
"""
from __future__ import annotations

import json
import os
import resource
import threading
import time

import grpc

from localai_tpu_torch import not_ported
from localai_tpu_torch.backend import pb
from localai_tpu_torch.backend.base import BackendServicer
from localai_tpu_torch.ops.sampling import SamplingParams


class LLMServicer(BackendServicer):
    def __init__(self, device=None, preloaded=None):
        """`device`: where LoadModel places the model (default: the CUDA
        device; "cpu" serves through the plain PyTorch versions).
        `preloaded=(engine, cfg, tok, name)` serves an engine built by the
        worker role's rank 0 (core/worker.py)."""
        self.device = device
        self.engine = None
        self.embedder = None
        self.scorer = None
        self.vision = None
        self.tok = None
        self.cfg = None
        self.model_name = ""
        self._world = None
        self.follower_output: list[str] = []
        self._state = pb.StatusResponse.UNINITIALIZED
        self._load_lock = threading.Lock()
        if preloaded is not None:
            self.engine, self.cfg, self.tok, self.model_name = preloaded
            self._state = pb.StatusResponse.READY

    # ------------------------------------------------------------ lifecycle

    def LoadModel(self, request, context):
        with self._load_lock:
            if self.engine is not None or self.embedder is not None:
                return pb.Result(success=True, message="already loaded")
            self._state = pb.StatusResponse.BUSY
            try:
                self._load(request)
                self._state = pb.StatusResponse.READY
                return pb.Result(success=True, message="ok")
            except Exception as e:  # surface load errors to the control plane
                self._state = pb.StatusResponse.ERROR
                return pb.Result(success=False,
                                 message=f"{type(e).__name__}: {e}")

    def _load(self, request):
        from localai_tpu_torch.engine.loader import load_config
        from localai_tpu_torch.models.bert import is_bert_dir
        from localai_tpu_torch.models.llava import is_llava
        from localai_tpu_torch.ops.kvcache import is_quant_kind

        if request.mesh_data > 1:
            raise not_ported("mesh_data (the data axis)", "parallel")
        # the KV tiers ride the ModelOptions.options JSON blob (no
        # dedicated proto field), as the reference's do
        kv_policy, kv_cold_pages, kv_host_bytes = "", 0, 0
        if request.options:
            opts = json.loads(request.options)  # typos fail the load loudly
            kv_policy = str(opts.get("kv_policy", ""))
            kv_cold_pages = int(opts.get("kv_cold_pages", 0))
            kv_host_bytes = int(opts.get("kv_host_bytes", 0))
        model_dir = request.model
        if request.model_path and not os.path.exists(model_dir):
            model_dir = os.path.join(request.model_path, request.model)
        if os.path.isfile(model_dir) and model_dir.endswith(".gguf"):
            raise not_ported("GGUF checkpoints", "other-roles")
        if not os.path.isdir(model_dir):
            raise FileNotFoundError(f"model directory not found: {model_dir}")
        tp = request.mesh_model or 1
        if tp > 1:
            for cond, what in (
                    (request.embeddings, "embeddings and rerank"),
                    (is_bert_dir(model_dir), "BERT embeddings"),
                    (is_llava(model_dir), "llava (images)")):
                if cond:
                    raise not_ported(f"{what} under a mesh", "parallel")
        if is_bert_dir(model_dir):
            # encoder checkpoint (BertModel/RobertaModel/...): the universal
            # embeddings role — no generation engine, Embedding RPC only
            self._load_bert(request, model_dir)
            return

        cfg = load_config(model_dir, dtype=request.dtype or None)
        # quant in EITHER field means int8 KV (one storage kind for both)
        kv_kind = "int8" if (is_quant_kind(request.cache_type_key)
                             or is_quant_kind(request.cache_type_value)) \
            else ""
        context_size = request.context_size or min(2048, cfg.max_position)
        if tp > 1:
            if request.draft_model:
                raise not_ported("speculative decoding under a mesh",
                                 "parallel")
            from localai_tpu_torch.core.worker import World

            self._world = World(model_dir, request.dtype or None, tp,
                                self.device)
        kv = dict(kv_policy=kv_policy, kv_cold_pages=kv_cold_pages,
                  kv_host_bytes=kv_host_bytes)
        try:
            self._load_engine(request, cfg, model_dir, kv_kind,
                              context_size, kv)
        except BaseException:
            self.free()
            raise
        if os.environ.get("LOCALAI_NO_PREWARM") != "1":
            self._prewarm()

    def _load_engine(self, request, cfg, model_dir, kv_kind, context_size,
                     kv):
        from localai_tpu_torch.engine.engine import Engine, EngineConfig
        from localai_tpu_torch.engine.loader import (
            load_config, load_params, load_tokenizer,
        )
        world = self._world
        mesh = None if world is None else world.mesh
        device = self.device if mesh is None else mesh.device
        params = load_params(model_dir, cfg, dtype=request.dtype or None,
                             device=device, mesh=mesh)
        tok = load_tokenizer(model_dir)
        draft = None
        if request.draft_model:
            # speculative decoding (reference DraftModel, backend.proto:218):
            # the draft loads and quantizes as the target does
            draft_dir = request.draft_model
            if request.model_path and not os.path.isdir(draft_dir):
                draft_dir = os.path.join(request.model_path, draft_dir)
            dcfg = load_config(draft_dir, dtype=request.dtype or None)
            draft = (dcfg, load_params(draft_dir, dcfg,
                                       dtype=request.dtype or None,
                                       device=device))
        # single-shot prefill up to the chunk size; longer prompts prefill in
        # chunk-sized pieces interleaved with running decodes
        chunk = min(512, context_size)
        buckets = tuple(request.prefill_buckets) or tuple(
            b for b in (64, 256, 512) if b <= chunk) or (chunk,)
        ec = EngineConfig(
            max_slots=request.parallel or 4,
            max_context=context_size,
            prefill_buckets=buckets,
            prefill_chunk=chunk,
            gamma=request.n_draft or 4,
            cache_type=kv_kind,
            kv_pages=request.kv_pages,
            mesh=mesh,
            replicator=None if world is None else world.replicator,
            **kv,
        )
        self.engine = Engine(cfg, params, tok, ec, draft=draft, device=device)
        if world is not None:
            from localai_tpu_torch.core.worker import engine_fields

            world.replicator.wait_for_followers()
            world.replicator.broadcast("engine", engine_fields(ec))
        if request.embeddings:
            from localai_tpu_torch.engine.embedder import (
                CrossScorer, Embedder,
            )

            self.embedder = Embedder(cfg, params, buckets=buckets,
                                     device=device)
            self.scorer = CrossScorer(cfg, params, buckets=buckets,
                                      device=device)
        from localai_tpu_torch.models.llava import is_llava, load_vision

        if is_llava(model_dir):
            # vision-language checkpoint: the CLIP tower + projector serve
            # request.images
            self.vision = load_vision(model_dir, device=device)
        self.cfg, self.tok = cfg, tok
        self.model_name = request.model
        self.engine.start()

    def _prewarm(self):
        """Build the kernels and run the serving paths once before LoadModel
        returns READY: the engine's all-inactive dispatches, then one short
        request per sampling tier (sort-free fast path, its 8x escalation
        tier, the full-sort path)."""
        from localai_tpu_torch.engine.engine import GenRequest

        self.engine.warmup()
        n = 3 * self.engine.ec.decode_block + 2
        W = self.engine.ec.sampling_topk_width
        warm = [SamplingParams(temperature=0.0, top_k=40),
                SamplingParams(temperature=0.8, top_p=0.9, top_k=0, seed=1)]
        if W and 2 * W <= self.cfg.vocab_size:
            warm.insert(1, SamplingParams(temperature=0.8, top_k=2 * W,
                                          seed=2))
        for sp in warm:
            _, q = self.engine.submit(GenRequest(
                prompt_ids=[1], max_tokens=n, ignore_eos=True, params=sp))
            while not q.get(timeout=600).finished:
                pass

    def _load_bert(self, request, model_dir: str):
        """Embedding-only load for BERT-family encoders: the generation
        RPCs stay FAILED_PRECONDITION (no engine), Embedding serves."""
        from localai_tpu_torch.engine.loader import load_tokenizer
        from localai_tpu_torch.models.bert import (
            BertEmbedder, load_bert_config, load_bert_params,
        )

        cfg = load_bert_config(model_dir, dtype=request.dtype or None)
        params = load_bert_params(model_dir, cfg, device=self.device)
        buckets = tuple(request.prefill_buckets) or (64, 256, 512)
        self.embedder = BertEmbedder(cfg, params, buckets=buckets,
                                     device=self.device)
        try:
            self.tok = load_tokenizer(model_dir)
        except FileNotFoundError:
            # a tokenizer-less checkpoint still serves prompt_ids
            self.tok = None
        self.cfg = cfg
        self.model_name = request.model

    # ------------------------------------------------------------ helpers

    def _require_engine(self, context):
        if self.engine is None:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          "no model loaded (call LoadModel first)")

    def _prompt_ids(self, request, context) -> list[int]:
        if request.prompt_ids:
            return list(request.prompt_ids)
        if self.tok is None:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          "no tokenizer; pass prompt_ids")
        if request.use_tokenizer_template and request.messages_json:
            messages = json.loads(request.messages_json)
            tools = None
            if request.tools_json:
                try:
                    tools = json.loads(request.tools_json) or None
                except json.JSONDecodeError:
                    context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                                  "tools_json is not valid JSON")
            return self.tok.encode_chat(messages, tools=tools)
        return self.tok.encode(request.prompt)

    @staticmethod
    def _sampling(request) -> SamplingParams:
        return SamplingParams(
            temperature=request.temperature,
            top_k=request.top_k or 0,
            top_p=request.top_p or 1.0,
            min_p=request.min_p,
            typical_p=request.typical_p or 1.0,
            repeat_penalty=request.repeat_penalty or 1.0,
            presence_penalty=request.presence_penalty,
            frequency_penalty=request.frequency_penalty,
            seed=request.seed if request.seed else -1,
            logit_bias=dict(request.logit_bias) or None,
        )

    def _submit(self, request, context):
        from localai_tpu_torch.engine.engine import GenRequest

        if request.audios:
            context.abort(grpc.StatusCode.UNIMPLEMENTED, str(not_ported(
                "audio inputs", "whisper")))
        resume = None
        max_tokens = request.tokens or 128
        if request.resume_json:
            # a preempted stream's ResumeToken: the prompt becomes original
            # + emitted, the payload drives the engine's RNG, grammar and
            # detokenizer fixups, and the budget shrinks by what the
            # preempted stream already produced
            from localai_tpu_torch.engine.resume import ResumeToken

            try:
                tok = ResumeToken.from_json(request.resume_json)
            except (ValueError, KeyError, TypeError) as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                              f"bad resume_json: {e}")
            ids = tok.resume_prompt
            resume = tok.payload()
            max_tokens = max(1, max_tokens - tok.generated)
        else:
            ids = self._prompt_ids(request, context)
        mm_embeds = mm_positions = None
        if request.images:
            if self.vision is None:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                              "model has no vision tower; images unsupported")
            try:
                ids, mm_embeds, mm_positions = self._encode_images(
                    ids, list(request.images))
            except Exception as e:
                # bad base64 (binascii.Error), not-an-image payloads
                # (PIL.UnidentifiedImageError, an OSError), placeholder
                # count mismatches (ValueError): client errors, never fatal
                context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                              f"bad image: {e}")
        req = GenRequest(
            prompt_ids=ids,
            params=self._sampling(request),
            max_tokens=max_tokens,
            resume=resume,
            stop=tuple(request.stop_prompts),
            ignore_eos=request.ignore_eos,
            logprobs=request.logprobs,
            grammar=request.grammar,
            context_shift=request.context_shift,
            prompt_cache_path=request.prompt_cache_path,
            prompt_cache_ro=request.prompt_cache_ro,
            mm_embeds=mm_embeds,
            mm_positions=mm_positions,
            deadline=(time.monotonic() + request.deadline_ms / 1e3
                      if request.deadline_ms else 0.0),
        )
        try:
            rid, out = self.engine.submit(req)
        except NotImplementedError as e:
            context.abort(grpc.StatusCode.UNIMPLEMENTED, str(e))
        except (ValueError, RuntimeError) as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        # RPC termination (client cancel/disconnect) evicts the slot; a
        # no-op after normal completion
        if context is not None:
            context.add_callback(lambda: self.engine.cancel(rid))
        return rid, out, ids

    def _encode_images(self, ids, images):
        """base64 images + prompt ids with <image> placeholders → (expanded
        ids, mm_embeds [K, H] f32, mm_positions [K]). The CLIP tower and
        projector run on the engine's device, per request, off the decode
        loop (models/llava.py)."""
        import numpy as np

        from localai_tpu_torch.models.llava import (
            decode_image_b64, encode_images, expand_image_tokens,
            preprocess_image,
        )

        vcfg, vparams, meta = self.vision
        px = np.concatenate(
            [preprocess_image(decode_image_b64(i), vcfg) for i in images])
        feats = encode_images(vparams, vcfg, meta, px).float().cpu().numpy()
        n_tok = feats.shape[1]                          # [N, n_tok, H]
        if meta.image_token_index not in ids and len(images) == 1:
            # a prompt without a placeholder (plain chat with an
            # attachment): the image goes first, llava's "<image>\n..."
            ids = [meta.image_token_index] + list(ids)
        ids, positions = expand_image_tokens(
            ids, len(images), n_tok, meta.image_token_index)
        return ids, feats.reshape(-1, feats.shape[-1]), positions

    # ------------------------------------------------------------ inference

    def Predict(self, request, context):
        self._require_engine(context)
        t0 = time.monotonic()
        text, ids, logprobs, ttft = [], [], [], 0.0
        _, out, _ = self._submit(request, context)
        while True:
            o = out.get()
            if o.token_id >= 0 and not ttft:
                ttft = time.monotonic() - t0
            if o.text:
                text.append(o.text)
            if o.token_id >= 0:
                ids.append(o.token_id)
                logprobs.append(o.logprob)
            if o.finished:
                break
        return pb.Reply(
            message="".join(text).encode(),
            tokens=o.generated_tokens,
            prompt_tokens=o.prompt_tokens,
            timing_prompt_processing=ttft,
            timing_token_generation=time.monotonic() - t0 - ttft,
            logprobs=logprobs if request.logprobs else [],
            token_ids=ids,
            finish_reason=o.finish_reason or "",
        )

    def PredictStream(self, request, context):
        self._require_engine(context)
        t0 = time.monotonic()
        ttft = 0.0
        _, out, ids = self._submit(request, context)
        first = True
        while True:
            o = out.get()
            if o.token_id >= 0 and not ttft:
                ttft = time.monotonic() - t0
            resume_json = ""
            if first and not o.finished:
                # the minimal checkpoint on the FIRST chunk: the tokenized
                # prompt, so a caller can rebuild prompt + emitted after an
                # ungraceful death (no spill-drain ran, no full token)
                resume_json = json.dumps({"v": 1, "prompt_ids": ids})
            elif o.finish_reason == "preempted" and o.resume is not None:
                # the spill-drain's checkpoint rides the terminal reply
                resume_json = json.dumps(o.resume)
            first = False
            yield pb.Reply(
                message=o.text.encode(),
                tokens=o.generated_tokens,
                prompt_tokens=o.prompt_tokens,
                timing_prompt_processing=ttft if o.finished else 0.0,
                timing_token_generation=(time.monotonic() - t0 - ttft)
                if o.finished else 0.0,
                logprobs=[o.logprob]
                if request.logprobs and o.token_id >= 0 else [],
                token_ids=[o.token_id] if o.token_id >= 0 else [],
                finish_reason=o.finish_reason or "",
                resume_json=resume_json,
            )
            if o.finished:
                return

    # ------------------------------------------------------------ aux RPCs

    def TokenizeString(self, request, context):
        if self.tok is None:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, "no tokenizer")
        ids = self.tok.encode(request.prompt)
        return pb.TokenizationResponse(length=len(ids), tokens=ids)

    def Embedding(self, request, context):
        if self.embedder is None:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          "model loaded without embeddings=true")
        if request.prompts:
            # batched: the whole input list in one RPC, one bucketed call
            if self.tok is None:
                context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                              "no tokenizer; batched embeddings need one")
            ids_batch = [self.tok.encode(p) for p in request.prompts]
            try:
                vecs = self.embedder.embed(ids_batch)
            except ValueError as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            return pb.EmbeddingResult(
                vectors=[pb.EmbeddingVector(values=v.tolist()) for v in vecs],
                prompt_tokens=sum(len(i) for i in ids_batch))
        ids = self._prompt_ids(request, context)
        try:
            vec = self.embedder.embed([ids])[0]
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        return pb.EmbeddingResult(embeddings=vec.tolist(),
                                  prompt_tokens=len(ids))

    def Rerank(self, request, context):
        """Cross-encoder rerank: each document scored by the LM's
        conditional log-likelihood given the query, query and document
        attending jointly (engine/embedder.py CrossScorer)."""
        if self.scorer is None:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          "model loaded without embeddings=true")
        if not request.query or not request.documents:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          "query and documents required")
        q_ids = self.tok.encode(request.query)
        d_ids = [self.tok.encode(d, add_bos=False)
                 for d in request.documents]
        try:
            sims = self.scorer.score(q_ids, d_ids)
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        order = sims.argsort()[::-1]
        top_n = request.top_n or len(order)
        resp = pb.RerankResult()
        for i in order[:top_n]:
            resp.results.append(pb.RerankedDocument(
                index=int(i), text=request.documents[int(i)],
                relevance_score=float(sims[int(i)])))
        return resp

    def Status(self, request, context):
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        return pb.StatusResponse(
            state=self._state,
            memory=pb.MemoryUsageData(total=rss, breakdown={"rss_peak": rss}),
        )

    def GetMetrics(self, request, context):
        m = dict(self.engine.metrics) if self.engine else {}
        return pb.MetricsResponse(metrics={k: float(v) for k, v in m.items()})

    def preempt(self, grace: float = 0.0) -> list[dict]:
        """Spill-drain the engine: freeze the live slots, spill their KV
        into the host pool, and end the open streams with terminal
        "preempted" replies carrying ResumeTokens. Returns the resume
        manifest (server.py's SIGTERM path calls this before stopping)."""
        if self.engine is None:
            return []
        return self.engine.preempt(grace)

    def free(self) -> list:
        """Unload: stop the engine and, on a mesh, the follower ranks
        (their `stop`, then their exit) and leave the process group,
        keeping their output in `follower_output`. Returns the followers'
        exit codes (printed too)."""
        if self.engine is not None:
            self.engine.stop()
            self.engine = None
        self.embedder = self.scorer = self.vision = None
        codes = []
        if self._world is not None:
            world, self._world = self._world, None
            codes = world.close()
            self.follower_output = world.outputs
            print(f"backend[llm] followers exited {codes}", flush=True)
        self._state = pb.StatusResponse.UNINITIALIZED
        return codes

    def shutdown(self):
        self.free()
