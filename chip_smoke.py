"""Chip smoke test of the PyTorch/CUDA port (localai_tpu_torch) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing its results on lines of its own; any failure raises
and the script exits non-zero:
  0. device: requires CUDA; prints the card's name and power limit
     (nvidia-smi), the torch and CUDA versions; turns TF32 off.
  1. build: prints `nvcc --version`, compiles the port's CUDA sources
     (csrc/*.cu, one nvcc each, in parallel) and, beside them, the grammar
     matcher (native/grammar.cpp, g++) into the git-ignored csrc/build/,
     and prints the build seconds.
  2. kernels vs plain at the main path's shapes (Llama-3.1-8B geometry:
     H=32, KVH=8, D=128): max abs error against each kernel's plain
     PyTorch version with its tolerance (the paged scatters: bit-exact over
     the whole pool; the flat-row scatters bit-exact outside the trash
     block), and the error of a planted fault that the check must reject;
     kernel/plain/library device times (CUDA events around a call the
     host enqueued while a spin kernel kept the card busy, median of 25
     after warmup; for the main prefill, dense decode and paged decode rows
     also with a cold L2: a 256 MB scratch buffer written before each rep;
     the paged decode cases print their spans and ring stages), the
     kernel's and the library call's times with the host's cost of the
     call in them (ms_host, library_ms_host: no spin), a call's device
     time inside a CUDA graph of 20 calls (ms_graph, as the fused loops
     replay them; the same three readings of an empty kernel give the
     harness's launch floor) and the least time the card could take
     (bound_ms). The ragged
     kernels run at phase 6's pack: T=192 rows, eight decode rows plus a
     128-row prefill chunk, over the 129-block pool; then the packs that
     exercise its split-KV work split (one 4095-token decode row, a 256-row
     chunk at offset 3840, dead q blocks, kv lengths at a span boundary and
     at MAXB*128, a window starting inside a span, G=16, head_dim 256 and
     512), each also against a dropped-split fault (line `phase2 ragged
     packs`). Then the wider
     geometries, each with its planted fault: ragged attention and paged
     decode at Qwen2-7B's H=28, KVH=4 (GQA group 7), dense decode at G=16
     (H=128, KVH=8), prefill at head_dim 256. Then the weight GEMMs:
     w8a16_matmul (int8 weight, bf16 x) at every 8B projection geometry
     for M = 4, 8, 16, 17, 192 and 2048, at Qwen2-7B's for M = 4, 192 and
     2048 (and one f32 case), against its plain version within two bf16
     steps an output and at most 1% of outputs differing, each with three
     planted faults (a K tile dropped, a K tile read as the one before it
     — a ring stage read before its load landed —, the scale applied
     before the bf16 rounding), library_ms the cast + matmul it
     replaces and library_bf16_ms cuBLAS on a bf16 weight; head_matmul
     (f32 logits) on the 8B head [4096, 128256] in bf16, int8 and tied at
     M = 4 and 8 and on Qwen2-7B's head (V = 152064), with a planted fault
     each (x32 rounded to bf16; a K tile dropped), library_ms the head's
     f32 copy + matmul (line `phase2 weight gemms`). Then the bf16 head's
     two routes (row 14: the SIMT route's f32 FMAs, and the tensor cores
     on x32's three bf16 terms) at M = 4, 8, 9, 16, 17, 40, 192, 2048
     and 8192, bf16 and tied, each route against the plain version with two
     planted faults (x32 rounded to bf16, the hi term alone; a K tile of
     the head dropped), both bounds (the f32-FMA one and the tensor
     cores' three passes) and the route head_plan takes (line `phase2
     head routes`); the tensor-core route on inputs whose lo terms carry
     the whole product (hi and mid cancel pair by pair along K), bf16
     and tied at M = 40, against the exact f64 logits within HEAD_TOL
     with the planted fault lo_term_dropped (line `phase2 head lo
     term`); and the split kernel bit for bit against its plain
     version on 8192 x 4096 values with the special ones among them (line
     `phase2 split terms`). Then the expert GEMM
     (moe_w8_matmul, row 15) at Mixtral-8x7B's experts (E = 8): (K, N) =
     (4096, 14336) on x shared by the experts and (14336, 4096) on one x
     slice an expert, M = 4, 192 and 2048, against its plain version
     within one bf16 step an output on at most 1% of them, each with two
     planted faults (expert e read with expert e + 1's scales; a K tile
     dropped), library_ms the reference's dequantize + torch.einsum (line
     `phase2 moe gemms`). Then the int4 twins of rows 13-15 (packed int4
     weights, two values a byte): w4a16_matmul at the 8B's projections
     and Qwen2-7B's wk/wv (3584, 512) for M = 4, 192 and 2048, the int4
     head [4096, 128256] at M = 4 and 192, moe_w4_matmul at Mixtral's
     experts for M = 1, 4, 8, 16, 192 and 2048, each against its plain
     version at the int8 row's tolerance, each with the nibbles of a byte
     swapped and read unsigned planted (the experts also the next
     expert's scales and, for the decode route's persistent grid, one
     unit's 64 K rows of expert 1 dropped),
     library_ms the reference's unpack + cast + matmul (dequantize +
     einsum), cold L2 readings at M = 4 (line `phase2 int4 gemms`). Then
     the speculative
     leg's shapes, each with its planted fault (line `phase2 spec
     shapes`): dense decode at the Llama-3.2-1B draft's H=32, KVH=8,
     D=64 (B=8, T=4096), w8a16_matmul on the 1B's projections at M = 8
     and head_matmul on its tied head [128256, 2048], w8a16_matmul on
     the 8B's projections and the 8B head at the verify's M = 8 x 5, and
     ragged attention and the flat-row scatters at a spec-as-ragged pack
     (eight 5-row windows in 8-row blocks beside a 128-row chunk). Then
     the KV tier's kernels, each with its planted faults (a ring map off
     by one column; the cold tier read without its scales), line `phase2
     kv tier`: the tiered paged decode at the 8B's widths (8 slots up to
     32768 tokens, sinks 256, window 4096) under the drop policy over bf16
     and int8 hot pools and with the cold tier (the middle demoted) over a
     bf16 pool, timed beside the untiered kernel over the full lengths,
     with bound_ms from the live bytes, plus f32 cases, H=28/KVH=4 and
     G=16; full-policy sentinels equal the untiered kernel bit for bit;
     the tiered ragged attention at phase 6's pack over ring tables
     (sinks 128, window 1024); the demotion (row 7's kernel over a hot
     block's rows) bit-exact, ms a layer and a 32-layer block.
  3. card vs CPU: an f32 model with the 8B widths and 2 layers, weights
     made once on the CPU from a fixed seed (the CPU's runs of this phase
     go on a thread while phase 1's nvcc processes build the kernels, and
     phase 2 waits for both); the same greedy request for 16
     tokens through the port on the CPU (plain versions) and on the card
     (kernels), dense and paged, gives the same tokens and first-step
     logits within tolerance; on the card paged tokens equal dense ones;
     a ragged engine (fused loop on, a second request admitted mid-decode)
     gives the same tokens on the card as on the CPU; on the card the
     fused loops of all three engines ran as CUDA graph replays. Then the
     graphs against the eager segments: engines at the 8B widths (2
     layers), dense, paged and ragged, bf16 and int8, serve four requests
     (greedy and seeded-sampled) twice — through graph replays and with
     each loop segment run eagerly by a test helper — and must give equal
     tokens and logprobs, bit for bit. Then grammar-constrained decoding
     on the same f32 model with the grammar leg's tokenizer (V = 128256):
     a table-backed tool-call grammar request, greedy and seeded-sampled,
     gives the same tokens on the card as on the CPU and as the
     host-masked path (grammar_table_states=0, decode_block=1,
     decode_loop=0) on the card, every token accepted by the port's
     matcher; on the dense, paged and ragged engines the grammar segments'
     graph replays equal the eager segments, bit for bit. Then
     speculative decoding on the same f32 target with a 1-layer f32 draft
     at the 1B's widths: the greedy spec streams on the card equal the
     CPU's, dense, paged and ragged; with the target as its own draft
     every proposal is accepted and the stream is the plain one. Then
     preemption on the card: a paged engine with an int8 pool and the
     host tier serves a greedy and a seeded-sampled request, is
     preempted, and a fresh engine adopting its pool resumes both
     ResumeTokens into the uninterrupted streams, token for token.
  4. the main path: a synthetic Llama-3.1-8B checkpoint served by the
     port's gRPC backend on 127.0.0.1 in bf16 and in the int8 recipe
     (int8 weights + int8 KV), four concurrent PredictStream requests each;
     the kernels' launch counters are zeroed just before and read just
     after. In phases 4-6 the fused loops run as CUDA graph replays: each
     run prints its graph runner's counters (captures, replays, steps
     replayed, warm-up steps) and fails if its fused loop served tokens
     without a replay, or if a decode attention or KV scatter kernel did
     not launch exactly once a layer a decode step. In phases 3 (the
     graph engines) to 6 the weight GEMMs must have launched exactly once
     a projection a layer a forward (w8a16_matmul, int8 recipe: 7 a
     layer) and once a forward that returns logits (head_matmul, both
     recipes), the forwards counted from the engine's metrics.
  5. the paged path: the same checkpoint served with kv_pages=129,
     parallel=8 and context_size=4096 (the pool holds half of what eight
     dense slots would), both recipes; six concurrent requests, then two
     that share the 640-token prompt of the first wave (retained-slot reuse
     and blocks borrowed through the prefix index), then eight 2000-token
     prompts that need more blocks than the pool holds (reclaim of retained
     blocks, deferred admission); checks prefix reuse, the pressure, the
     pool's peak, that only the recipe's paged kernels launched, and three
     greedy requests' served tokens against a teacher-forced plain forward
     of the same model (plain attention and the weight GEMMs' plain
     versions).
  6. the ragged path: the same synthetic model served in-process by the
     port's Engine with ragged continuous batching (max_slots=8,
     max_context=4096, kv_pages=129, ragged_token_budget=192, the fused
     ragged loop of 16 steps), both recipes; four requests (prompts 1, 17,
     300, 700), then, once they decode, four more (1500, 2000, 40, 640),
     64 new tokens each; checks that every prompt token was packed into
     ragged ticks, that the loop exited on finishes and on pending prefill,
     that the recipe's ragged kernels launched and the prefill and dense
     decode kernels did not, and three greedy requests against the
     teacher-forced reference. Then the same run on a synthetic checkpoint
     of Qwen2-7B's published widths (Qwen2ForCausalLM: hidden 3584, 28
     layers, 28 heads on 4 KV heads, head_dim 128, QKV bias, untied head,
     vocab 152064), both recipes, with the same checks. Phases 6-7 and
     9-11 serve their models at 4 of their layers (SERVE_LAYERS), the
     published widths kept.
  7. grammar-constrained decoding at full width. The leg's checkpoint is
     a directory of its own: the synthetic Llama-3.1-8B's config and a
     ByteLevel BPE tokenizer written here (the 256 byte symbols, strings
     of 2-8 JSON-ish characters from a seed, no merges, an EOS token;
     128256 entries). The grammar tables at V = 128256: the tool-call
     grammar's build seconds and states, the JSON grammar's overflow, the
     device tables' bytes. One wave of four streams — two on the tool-call
     grammar (greedy, seeded-sampled; device tables, fused loops), one on
     the generic JSON grammar (it overflows the tables: host-only, the
     block path with rollbacks), one free — with a malformed GBNF sent
     mid-wave, then the same prompts as four free streams (the baseline
     tok/s): through the gRPC backend on the dense path (bf16, int8
     recipe) and, on phase 6's Llama weights, an in-process ragged Engine
     of phase 6's shape. Checks: every grammar stream's tokens up to EOS
     or its budget are accepted by the port's matcher; the table-backed
     streams ran as graph replays of the grammar key; the host-only one
     took the block path; the malformed GBNF gets INVALID_ARGUMENT (a
     ValueError at the Engine's submit) while the others finish; the
     greedy tool-call stream passes the teacher-forced check with each
     reference row masked by the matcher. Each reading line carries the
     card's name and power limit.
  8. speculative decoding at full width: the synthetic Llama-3.1-8B (4
     of its 32 layers) with a synthetic draft of Llama-3.2-1B's published
     widths (hidden 2048, 2 of its 16 layers, 32 heads on 8 KV heads,
     head_dim 64, tied head), gamma 4, bf16 then the int8 recipe: the gRPC backend's
     LoadModel(draft_model, n_draft=4) on the dense path (phase 4's
     prompts, the fourth greedy), then draft Engines in-process on phase
     5's pool (kv_pages=129, 8 slots; phase 6's two waves of requests,
     first without the draft) and on phase 6's ragged path. Checks: three
     greedy streams a path pass the teacher-forced check, whose planted
     fault — the draft's own proposals, as an accept test that takes
     every draft would serve them — fails; the draft's dense decode
     launched (gamma+1) x 8 times a spec dispatch, counted from the
     engine's metrics, the target's decode kernels never, and on the
     ragged path ragged attention and the flat-row scatter once a layer a
     spec-as-ragged dispatch, no fused loop; then a perfect draft (2
     layers at the 8B widths, bf16, draft = target) accepts >= 0.95,
     dense and ragged. Prints tok/s and TTFT p50 with and without the
     draft, the acceptance (near 0 with random weights: not a finding),
     and a spec dispatch's host and device-busy ms, split into the draft
     steps, the verify and the accept tail.
  9. the host KV spill tier, preemption and resume at full width: the
     synthetic Llama-3.1-8B (4 of its 32 layers) with the grammar leg's
     tokenizer, bf16 then the int8 recipe, in-process Engines on phase 5's
     pool (kv_pages=129, 8 slots, prompt cache on) with kv_host_bytes =
     256 MiB (248 int8 blocks, as 2 GiB at 32 layers).
     9.1: waves A1 (8 conversations, 2000-token prompts), A2 (8 unrelated
     2000-token prompts, which reclaim or rewrite A1's retained blocks:
     they spill) and A3 (A1's follow-ups: prompt + reply + 100 new
     tokens, readmitted from the host), with the tier and without;
     checks that every A1 full block reached the host, that A3's reused
     prompt tokens all came from readmitted blocks (at least 7 of 8
     conversations whole), that the int8 pages readmitted hold the
     spilled bytes, and three A3 streams against the teacher-forced
     reference, whose planted fault — an engine readmitting with the
     scales dropped — fails. 9.2: eight greedy 600-token requests
     preempted mid-decode by Engine.preempt(), resumed on a fresh engine
     adopting the pool (8 readmits, 0 re-prefills) and on one without it
     (0, 8); the text before and after the preemption is the stream's,
     and three resumed streams pass the teacher-forced check. 9.3: the
     port's backend process (LoadModel with kv_host_bytes, bf16) streams
     phase 4's prompts and gets SIGTERM once each has 16 tokens: every
     stream ends "preempted" with a resume_json, the process exits 0, and
     a new backend process resumes each (re-prefill) to its budget with
     the joined text the detokenized ids. Prints, each with the card:
     spill and readmit ms a block and GB/s (and a spill into newly pinned
     memory), the A3 wave's host ms in the tier's methods, the drain's
     wall ms and blocks, host bytes at peak, A3's TTFT p50 with and
     without the tier, resume TTFT p50 by readmit and by re-prefill, and
     the launches of the paged decode and scatter kernels in the phase.
 10. the KV retention tier at full width: the synthetic Llama-3.1-8B (4 of its
     32 layers) with the grammar leg's tokenizer, in-process Engines of 4 slots
     and 8192-token contexts, four 6000-token prompts of 256 new tokens (three
     greedy, one seeded): kv_policy full (a pool of four contexts);
     sink_window(sinks=128, window=1024) on the paged and the ragged path
     (budget 192), bf16 and the int8 recipe (pools of 4 x 13 resident blocks +
     1); with quantize_cold over a bf16 pool (a cold pool of 4 x 49 + 1 blocks;
     paged only, as the reference); then the gRPC backend's LoadModel with
     kv_policy in its options serving phase 4's prompts. Checks: every stream
     to its budget; kv_blocks_peak <= 4 x the resident blocks; kv_evictions
     (drop) and kv_cold_blocks (cold) exactly 4 x 39 (_kv_tick's rule at the
     final length); the tiered reads launched and no untiered one (the full
     engine: no tiered one), the demotion one launch a layer a cold block;
     three greedy streams an engine against a teacher-forced plain forward
     under the same retention (the sink and window mask; the demoted middle
     through the quantize_tokens round trip), whose planted fault — a stream
     held to another prompt — fails; a second wave of per-request policies
     ("full", a narrower window) on the paged bf16 engine captures no new
     graph. Prints, each with the card: tok/s, TTFT p50, busy ms a decode step
     (CUDA events around each fused-loop segment replay), the seconds to
     prefill, the demote's ms a block, the tiered launches.
 11. context shift and the disk prompt cache at full width: the synthetic
     Llama-3.1-8B (4 of its 32 layers) with the grammar leg's tokenizer.
     11.1: in-process Engines of 4 slots and 1024-token contexts (dense bf16
     and int8, paged bf16 and int8 on a pool of 41 blocks, ragged bf16
     with a budget of 192) serve four 900-token prompts of 700 new tokens
     with context_shift (three greedy, one seeded). Checks: every stream
     to its budget; exactly two shifts a stream (counted around
     Engine._dev_shift); the path's decode kernels launched and no plain
     version ran; no graph captured in the wave and replays after every
     shift; each greedy stream against a plain forward carried through
     the same shifts (plain_shift, written apart from the port's: the
     slot's K/V rows right after each shift within SHIFT_KV_TOL of the
     reference cache's, each served token within 0.25 logit of its
     row's largest), whose planted fault — an engine whose shift slides
     without rotating K — fails. 11.2, on the paged bf16 engine: a
     512-token prefix P retained, a tenant holding its blocks, a shifting
     tenant whose prompt starts with P (lcp 0, every page its own at each
     shift), then a P tenant that reuses the retained blocks and streams
     the first tenant's tokens. 11.3, dense bf16 then int8 (2 slots, 4096
     tokens): an 1800-token prompt saved by prompt_cache_path at release,
     a fresh engine's follow-up (+200 tokens, 64 new) cold and from the
     file (prompt_cache_hits 1, prompt_tokens_reused 1800, the
     teacher-forced check), then read-only (the file's bytes and mtime
     unchanged). Prints, each with the card: tok/s, TTFT p50, busy ms a
     decode step, the shifts a stream, the device and host ms of each
     shift; the file's MB, save and load ms, and the follow-up's prefill
     and TTFT from the file against cold.
 12. Mixtral-8x7B at its published widths (MixtralForCausalLM: hidden
     4096, 8 experts of 14336, top-2, 32 heads on 8 KV heads, vocab 32000,
     rope_theta 1e6), synthetic checkpoints written here. The int8 recipe
     (int8 weights and KV, 32 layers, about 47 GB) through the gRPC
     backend's LoadModel on the dense engine, phase 4's four requests in
     Mixtral's vocabulary; then an in-process ragged Engine (phase 6's
     pool, budget 192) on the same weights, one wave of the four. bf16 at
     16 of its 32 layers (93 GB of bf16 weights exceed the card), one
     dense request. Checks: every stream to its budget; each leg's
     attention kernels launched, moe_w8_matmul once an expert stack a
     layer a forward in int8 (w8a16_matmul once an attention projection),
     neither in bf16, and no plain version ran; no graph captured in a
     wave; the greedy streams against the teacher-forced plain forward on
     the card, whose planted fault fails: within ROUTE_MARGIN (1.5 logit)
     on the top-2 legs, where a near tie of the router moves a row (see
     ROUTE_MARGIN), and within phase 5-11's 0.25 on a control leg that
     serves the int8 weights with every expert routed (top-8, a
     continuous combine; an in-process dense Engine, the greedy
     requests). Prints, each with the card: tok/s, TTFT p50, busy ms a
     decode step, the launches.
 13. the int4 recipe at full width (int4 weights, int8 KV): the synthetic
     Llama-3.1-8B at its 32 layers through the gRPC backend's
     LoadModel(dtype="int4") on the dense engine, phase 4's four
     requests, then an in-process ragged Engine of phase 6's shape on the
     same weights, one wave; then Mixtral-8x7B at its 32 layers (22.5 GB
     of int4 experts, where phase 12's bf16 leg needed 16) through
     LoadModel, four requests, and its top-8 control leg. Checks: every
     stream to its budget; the int4 weight kernels (w4a16_matmul,
     head_matmul_int4, moe_w4_matmul) launched once a projection (expert
     stack, forward with logits) a layer a forward, no int8 weight GEMM
     and no plain version; no graph captured in a wave; the greedy
     streams against the teacher-forced plain forward (0.25 logit;
     Mixtral's top-2 legs ROUTE_MARGIN beside the top-8 control at
     0.25), whose planted fault fails; the projections' q bytes K x N / 2
     each, printed against the int8 recipe's. Prints, each with the
     card: tok/s, TTFT p50, busy ms a decode step, the launches.
 14. tensor parallelism on the one card: row 12's six *_sharded wrappers
     (paged_scatter_append[_q8], ragged_paged_attention[_q8],
     ragged_scatter_append[_q8]), each run on the two KV-head shards (4 of
     the 8B's 8 heads a rank) of a whole pool and joined, against the
     unsharded plain version (the scatters bit-exact, attention at rows
     8/9's tolerance; the shards joined in the wrong rank order rejected),
     timed at rank 0's shard beside the unsharded kernel. Then the
     synthetic Llama-3.1-8B served by two ranks on cuda:0 over gloo (the
     smoke as rank 0, one follower process of the worker role whose output
     goes to a log file): dense and paged through the gRPC backend's
     LoadModel(mesh_model=2), ragged through the worker role's World and
     an Engine of phase 6's shape, bf16 then the int8 recipe, four streams
     a leg, 32 new tokens each, at 8 of the 8B's 32 layers (TP_LAYERS).
     Checks: every stream to its budget; the
     leg's kernels launched through the sharded wrappers and no unsharded
     scatter or ragged kernel; the three greedy streams teacher-forced
     through the one-rank model on the same synthetic weights within 0.25
     logit (planted fault rejected); every *_sharded counter above 0; the
     follower exits 0. Prints, each with the card: tok/s, TTFT p50, rank
     0's collectives' ms a decode step (host clock inside gloo's calls,
     after a synchronize), its busy and idle ms a decode step
     (torch.profiler: the union of its CUDA activities against the wall),
     the follower's own launch counts.
 15. the llm backend's other roles at published widths. 15.1: the
     synthetic Llama-3.1-8B (32 layers, write_tokenizer's tokenizer) through
     the gRPC backend's LoadModel(embeddings=true, prefill_buckets=[64,
     256, 1024]), bf16 then the int8 recipe: Embedding of 17, 200 and 900
     ids (one bucket each), the Embedder on eight id lists in the 1024
     bucket, the CrossScorer on a 32-token query and eight documents of
     64-400 tokens (M = 8192 rows through the head), the batched `prompts`
     Embedding and Rerank through the tokenizer; checks: flash_prefill
     launched 32 times a forward, w8a16_matmul (int8) 7 x 32, head_matmul
     once a scorer forward, nothing else and no plain version; the
     vectors within cosine 0.999 and the scores within 0.05 (and in order
     where two differ by more than 0.1) of the same calls with every
     kernel's plain version on the card; Rerank and `prompts` equal the
     in-process calls. 15.2: BAAI/bge-large-en-v1.5's BertModel widths
     (24 layers, hidden 1024, 16 heads, vocab 30522; weights from a seed,
     a safetensors file written here): LoadModel on its directory (the
     encoder alone), Embedding at 17, 200 and 500 ids and of two texts,
     TokenizeString, and a batch of eight at 512; card against the port
     on the CPU (f32): cosine >= 0.999; no kernel launches (bidirectional
     attention: plain matmuls). 15.3: llava-1.5-7b (Llama-2-7B text
     widths, vocab 32064, the image token 32000; the CLIP ViT-L/14-336
     tower and projector, about 0.32 B values from a seed written here,
     the text side synthetic): four PredictStream requests over gRPC at 32
     layers, one PNG each (~40 text tokens, 576 image rows: chunked extend
     with the rows injected), 32 new tokens; then in-process Engines at
     SERVE_LAYERS: paged (single-shot prefill with the rows injected),
     ragged with bf16 and with int8 KV (the rows packed into the flat
     stream), and an
     identity leg (a dense int8-KV engine: a prompt's own embedding rows
     injected give its token prompt's greedy tokens, the image rows other
     tokens). Checks: every stream to its budget; the path's kernels
     launched and no plain version; every prompt token packed on the
     ragged engine; the greedy streams within 0.25 logit of a teacher-
     forced plain forward fed the same image rows (planted fault: none).
     Prints, each with the card: each call's wall and device-busy ms,
     the cosines and scores, the tower's ms an image, TTFT p50, tok/s and
     the launches; then row 14 at M = 8192 (the scorer's head) and row 1
     at the embeddings batch and llava's text widths, timed after the
     phase's counts are read.
The second line from the end is {"kernels": [...]} (the six wrappers of
row 12 among them; `launches_roles`: phase 15's; split_bf16_terms's
`launches` are phase 15's, where the scorer's head splits x32; the
head_matmul row carries row 14 at M = 8192 as `large_m`, the
moe_w4_matmul row its w2 stack's readings as `w2`); the last line is
{"ok": true, "device": {...}}. It imports nothing of JAX or
localai_tpu.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import os
import subprocess
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))

# Llama-3.1-8B geometry (bench.py's 8b model; HF config of
# meta-llama/Llama-3.1-8B)
CFG_8B = {
    "architectures": ["LlamaForCausalLM"],
    "vocab_size": 128256, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 128,
    "max_position_embeddings": 131072, "rms_norm_eps": 1e-5,
    "rope_theta": 500000.0, "tie_word_embeddings": False,
    "rope_scaling": {"rope_type": "llama3", "factor": 8.0,
                     "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192},
}

# Llama-3.2-1B's published widths (HF config of meta-llama/Llama-3.2-1B):
# the speculative leg's draft (tied head, head_dim 64)
CFG_1B = {
    "architectures": ["LlamaForCausalLM"],
    "vocab_size": 128256, "hidden_size": 2048, "intermediate_size": 8192,
    "num_hidden_layers": 16, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 64,
    "max_position_embeddings": 131072, "rms_norm_eps": 1e-5,
    "rope_theta": 500000.0, "tie_word_embeddings": True,
    "rope_scaling": {"rope_type": "llama3", "factor": 32.0,
                     "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192},
}

# Qwen2-7B's published widths (HF config of Qwen/Qwen2-7B): GQA group 7 (28
# heads on 4 KV heads, head_dim 128), QKV bias, untied head. Its
# `sliding_window` (131072) is kept although `use_sliding_window` is false:
# both packages' loaders read `sliding_window` alone, and 131072 is longer
# than any context here, so the window masks nothing.
CFG_QWEN2_7B = {
    "architectures": ["Qwen2ForCausalLM"],
    "vocab_size": 152064, "hidden_size": 3584, "intermediate_size": 18944,
    "num_hidden_layers": 28, "num_attention_heads": 28,
    "num_key_value_heads": 4, "max_position_embeddings": 131072,
    "rms_norm_eps": 1e-6, "rope_theta": 1000000.0,
    "tie_word_embeddings": False, "sliding_window": 131072,
    "use_sliding_window": False, "max_window_layers": 28,
}

# the depth at which phases 6-7 and 9-11 serve their models (the 8B, and
# phase 6's Qwen2-7B), at their published widths: a leg's seconds (waves,
# graph captures, teacher-forced forwards) grow with the layers, and at
# full depth the smoke outran its time limit on a slower host (4 layers
# once phase 13 joined it). Phases 4-5 (the main path), phase 12's int8
# leg and phase 13 keep full depth.
SERVE_LAYERS = 4
CFG_8B_CUT = dict(CFG_8B, num_hidden_layers=SERVE_LAYERS)
CFG_QWEN2_7B_CUT = dict(CFG_QWEN2_7B, num_hidden_layers=SERVE_LAYERS)

# the grammar leg's grammars, as GBNF text (what the control plane sends
# the backend in PredictOptions.grammar): a forced call of one tool (the
# OpenAI tools schema {"name", "arguments"} of a get_weather function, with
# tool_choice "required"), whose automaton fits the device tables, and the
# generic JSON grammar of response_format json_object, whose unbounded
# nesting overflows them (host-only)
TOOL_SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"const": "get_weather"},
        "arguments": {
            "type": "object",
            "properties": {"location": {"type": "string"},
                           "unit": {"enum": ["celsius", "fahrenheit"]}},
            "required": ["location", "unit"]}},
    "required": ["name", "arguments"]}
TOOL_GBNF = "\n".join([
    r'root ::= root-v space',
    r'space ::= " "?',
    r'root-v-name ::= "\"get_weather\"" space',
    r'string ::= "\"" (',
    r'  [^"\\\x00-\x1f] |',
    r'  "\\" (["\\/bfnrt] | "u" [0-9a-fA-F] [0-9a-fA-F] [0-9a-fA-F] '
    r'[0-9a-fA-F])',
    r')* "\"" space',
    r'root-v-arguments-unit ::= ("\"celsius\"" | "\"fahrenheit\"") space',
    r'root-v-arguments ::= "{" space "\"location\"" space ":" space string '
    r'"," space "\"unit\"" space ":" space root-v-arguments-unit "}" space',
    r'root-v ::= "{" space "\"name\"" space ":" space root-v-name "," space '
    r'"\"arguments\"" space ":" space root-v-arguments "}" space',
])
JSON_GBNF = "\n".join([
    r'root ::= object',
    r'space ::= " "?',
    r'object ::= "{" space (string ":" space value ("," space string ":" '
    r'space value)*)? "}" space',
    r'array ::= "[" space (value ("," space value)*)? "]" space',
    r'string ::= "\"" (',
    r'  [^"\\\x00-\x1f] |',
    r'  "\\" (["\\/bfnrt] | "u" [0-9a-fA-F] [0-9a-fA-F] [0-9a-fA-F] '
    r'[0-9a-fA-F])',
    r')* "\"" space',
    r'number ::= ("-"? ([0-9] | [1-9] [0-9]*)) ("." [0-9]+)? '
    r'([eE] [-+]? [0-9]+)? space',
    r'boolean ::= ("true" | "false") space',
    r'null ::= "null" space',
    r'value ::= object | array | string | number | boolean | null',
])

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): bf16 tensor cores,
# f32 outside the tensor cores (the port's f32 paths never use TF32), HBM3
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# a spin of about 0.5 ms at the H100's 1.98 GHz boost clock (_time_ms)
SPIN_CYCLES = 1_000_000

# Kernel vs plain version: |out - ref| <= atol + rtol * |ref|. bf16: rtol
# 2**-7 (one bf16 ulp, relative) plus atol 1e-3; f32: 2e-5 absolute. Both
# compute in f32 and round once to the output dtype, so they differ by the
# f32 summation order, which moves an output by at most one rounding step.
# The bf16 prefill kernel multiplies on the tensor cores: bf16 inputs (exact)
# into f32 sums, and p — f32 in the plain version — enters P V as two bf16
# terms, hi + lo, which carry it to about 2**-17 relative (one bf16 term
# alone put outputs 2 ulps off).
TOL = {"bfloat16": (1e-3, 2 ** -7), "float32": (2e-5, 0.0)}


# (seconds since the previous log line, the line's head) for each line
# that ended a gap of at least a second: the `slowest steps` line
STEPS: list = []
_LAST_LOG = [time.perf_counter()]


def log(*a):
    now = time.perf_counter()
    gap, _LAST_LOG[0] = now - _LAST_LOG[0], now
    if gap >= 1.0:
        STEPS.append((round(gap, 1), " ".join(map(str, a))[:56]))
    print(*a, flush=True)


# ------------------------------------------------------------------ phase 0

def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script needs an NVIDIA card")
    if not os.path.isdir(os.path.join(HERE, "localai_tpu_torch")):
        raise SystemExit("chip_smoke: localai_tpu_torch/ not found beside "
                         "this script")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16/f16 GEMMs reduce split-K partials in f32, as the reference sums
    # (the plain versions' cuBLAS calls; the port's kernels always do)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    return smi


# ------------------------------------------------------------------ phase 1

def phase_build():
    from localai_tpu_torch.ops.kernels import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    log("nvcc " + " ".join(nvcc.stdout.strip().splitlines()[-2:]))
    import threading

    from localai_tpu_torch import native

    # the grammar matcher (g++) builds beside the CUDA sources (nvcc)
    gxx = {}

    def build_grammar():
        t = time.perf_counter()
        try:
            native.build_and_load("grammar")
        except Exception as e:     # re-raised below, on the main thread
            gxx["error"] = e
        gxx["s"] = time.perf_counter() - t

    th = threading.Thread(target=build_grammar)
    t0 = time.perf_counter()
    th.start()
    built = _build.build_all()
    th.join()
    secs = time.perf_counter() - t0
    if "error" in gxx:
        raise gxx["error"]
    for name, s in built.items():
        log(f"build {name}: {s:.1f} s")
    log(f"build grammar.cpp (g++): {gxx['s']:.1f} s -> "
        f"{os.path.relpath(native.so_path('grammar'), HERE)}")
    log(f"phase1 build: {secs:.1f} s wall for {sorted(built) or 'cached'}")
    for name in _build.SOURCES:
        _build.load(name)
    return secs


# ------------------------------------------------------------------ phase 2

def _time_ms(fn, reps=25, warm=3, cold=False, spin=True):
    """Median device ms of `reps` calls of fn, each between two CUDA
    events, after `warm` calls. Before each rep's start event a spin kernel
    (torch.cuda._sleep, about 0.5 ms) keeps the card busy while the host
    enqueues the event and fn's launches, so the time between the events
    is the card's: the host's cost of a call (Python, ctypes, the launch)
    does not enter it, for kernel, plain version and library call alike.
    spin=False leaves the card idle instead, so a short call's time is
    mostly the host's cost of it (the `ms_host` and `library_ms_host`
    readings). cold=True also
    writes a 256 MB scratch buffer (five times the 50 MB L2) before the
    start event, so the call finds its inputs in device memory, not in the
    L2."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda") \
        if cold else None
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        if flush is not None:
            flush.fill_(1.0)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


# calls of one kernel captured in one CUDA graph for its in-graph reading
GRAPH_CALLS = 20


def _graph_ms(fn, calls=GRAPH_CALLS):
    """Device ms of one call of fn inside a CUDA graph, as the fused decode
    loops replay their kernels: `calls` calls captured in one graph, the
    replay timed as _time_ms times a call (behind a spin kernel, median of
    25), divided by `calls`. Launching from a graph skips the host's cost
    of a call and the launch latency between kernels."""
    import torch

    from localai_tpu_torch.engine.graphs import gc_paused

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with gc_paused(), torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = _time_ms(graph.replay, warm=2)
    del graph
    return ms / calls


# the card's L2 (H100: 50 MB); a served decode step streams a new weight
# every launch (one int4 layer of the 8B is ~109 MB)
L2_BYTES = 50 << 20


def _graph_cold_ms(fn_on, nbytes, calls=GRAPH_CALLS):
    """Device ms of one call inside a CUDA graph whose calls cycle through
    n distinct copies of the call's weight, n the least (4 at least) whose
    bytes exceed twice the L2: each call finds its weight in device memory,
    as a served graph's projections do. fn_on(i) is the call on copy i."""
    import torch

    from localai_tpu_torch.engine.graphs import gc_paused

    n = max(4, -(-2 * L2_BYTES // nbytes))
    fns = [fn_on(i) for i in range(n)]
    calls = max(calls, n)
    for f in fns:
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with gc_paused(), torch.cuda.graph(graph):
        for c in range(calls):
            fns[c % n]()
    ms = _time_ms(graph.replay, warm=2)
    del graph, fns
    return ms / calls


def launch_floor():
    """The harness's floor: an empty kernel (torch.cuda._sleep(0), one
    thread that returns at once) timed as the kernels are — device ms
    behind a spin, host-inclusive ms, and ms inside a graph."""
    import torch

    def empty():
        torch.cuda._sleep(0)

    res = {"ms": _time_ms(empty), "ms_host": _time_ms(empty, spin=False),
           "ms_graph": _graph_ms(empty)}
    log("phase2 launch floor (empty kernel) " + json.dumps(res))
    return res


def _prefill_case(B, S, H, KVH, D, dtype, lengths, window=None, seed=0):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, S, H, D, device="cuda", generator=g).to(dtype)
    k = torch.randn(B, S, KVH, D, device="cuda", generator=g).to(dtype)
    v = torch.randn(B, S, KVH, D, device="cuda", generator=g).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, k, v, lens, window


def _decode_case(B, H, KVH, T, D, dtype, lengths, q8=False, seed=0):
    import torch

    from localai_tpu_torch.ops.kvcache import quantize_tokens

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, 1, H, D, device="cuda", generator=g).to(dtype)
    k = torch.randn(B, KVH, T, D, device="cuda", generator=g)
    v = torch.randn(B, KVH, T, D, device="cuda", generator=g)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    if not q8:
        return q, k.to(dtype), v.to(dtype), lens
    kq, ks = quantize_tokens(k)
    vq, vs = quantize_tokens(v)
    return (q, kq, ks.reshape(B, KVH, T // 128, 128), vq,
            vs.reshape(B, KVH, T // 128, 128), lens)


def _compare(out, ref, tol, lengths=None):
    """(max |out - ref|, max of |out - ref| - rtol * |ref|) with tol =
    (atol, rtol); the pair passes when the second is at most atol. With
    `lengths`, only query rows below each row's length count (prefill:
    padding rows are don't-care by the kernels' contract)."""
    _, rtol = tol
    if lengths is not None:
        pairs = [(out[b, :n], ref[b, :n]) for b, n in enumerate(lengths)
                 if n > 0]
    else:
        pairs = [(out, ref)]
    err = excess = float("-inf")
    for o, r in pairs:
        d = (o.float() - r.float()).abs()
        err = max(err, float(d.max()))
        excess = max(excess, float((d - rtol * r.float().abs()).max()))
    return err, excess


def _mismatch(out, ref):
    """The share of outputs that differ at all."""
    return float((out != ref).float().mean())


def _check_close(name, out, ref, tol, lengths=None, fault=None, share=None):
    """Raise unless out agrees with ref within tol (and, with `share`, at
    most that share of the outputs differs at all). With `fault` (a plain
    result of a deliberately wrong computation, or {label: result}), also
    raise unless the same limit rejects each, and report its error."""
    err, excess = _compare(out, ref, tol, lengths)
    res = {"max_abs_err": err, "tol": f"atol {tol[0]:g} + rtol {tol[1]:g}"}
    if share is not None:
        res["mismatch_share"] = _mismatch(out, ref)
        res["tol"] += f", at most {share:g} of outputs differing"
    if not excess <= tol[0] or res.get("mismatch_share", 0.0) > (share or 0):
        raise AssertionError(f"{name}: max_abs_err {err}, excess over rtol "
                             f"{excess} > atol {tol[0]}, or mismatch share "
                             f"{res.get('mismatch_share')} > {share}")
    faults = fault if isinstance(fault, dict) else (
        {} if fault is None else {"planted_fault": fault})
    for label, f in faults.items():
        f_err, f_excess = _compare(out, f, tol, lengths)
        f_share = _mismatch(out, f) if share is not None else None
        if f_excess <= tol[0] and (share is None or f_share <= share):
            raise AssertionError(f"{name}: the limit does not reject the "
                                 f"planted fault {label} ({f_err}, "
                                 f"share {f_share})")
        res[label + "_err"] = f_err
        if f_share is not None:
            res[label + "_mismatch_share"] = f_share
    return res


def check_prefill(B, S, H, KVH, D, dtype, lengths, window=None,
                  timed=True, cold=False):
    """With timed=True also plants a fault — the 64 keys furthest back
    dropped for the query rows that have more than L - 64, L the longest
    length (a window of L - 64; for L <= 128 a window of half of L) — and
    checks that the tolerance rejects it. cold=True also times kernel and library
    with a cold L2."""
    import torch
    import torch.nn.functional as F

    from localai_tpu_torch.ops.kernels import flash_prefill, \
        flash_prefill_plain

    q, k, v, lens, window = _prefill_case(B, S, H, KVH, D, dtype, lengths,
                                          window)
    out = flash_prefill(q, k, v, lens, sliding_window=window)
    torch.cuda.synchronize()
    ref = flash_prefill_plain(q, k, v, lens, sliding_window=window)
    longest = max(lengths)
    fault_window = longest - 64 if longest > 128 else max(longest // 2, 1)
    fault = flash_prefill_plain(q, k, v, lens, sliding_window=fault_window) \
        if timed and window is None else None
    name = f"flash_prefill {str(dtype).split('.')[-1]} B={B} S={S} " \
           f"H={H} KVH={KVH} D={D} lengths={lengths} window={window}"
    res = _check_close(name, out, ref, TOL[str(dtype).split(".")[-1]],
                       lengths, fault)
    if timed:
        es = q.element_size()
        # only the rows below each length are work: q and out over those
        # rows, k and v over the same rows, lengths once
        rows = sum(min(n, S) for n in lengths)
        pairs = sum(min(i + 1, window or S) for n in lengths
                    for i in range(min(n, S)))
        flops = 4.0 * pairs * H * D
        nbytes = es * rows * (2 * H * D + 2 * KVH * D) + 4 * B
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        res.update(
            ms=_time_ms(lambda: flash_prefill(q, k, v, lens,
                                              sliding_window=window)),
            ms_host=_time_ms(lambda: flash_prefill(
                q, k, v, lens, sliding_window=window), spin=False),
            ms_graph=_graph_ms(lambda: flash_prefill(
                q, k, v, lens, sliding_window=window)),
            plain_ms=_time_ms(lambda: flash_prefill_plain(
                q, k, v, lens, sliding_window=window)),
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            bound_formula=(f"max({flops:.4g} flop / "
                           f"{peak / 1e12:.0f} TFLOP/s, {nbytes:.4g} B / "
                           f"3.35 TB/s)"))
        if window is None:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            res["library_ms"] = _time_ms(library)
            res["library_ms_host"] = _time_ms(library, spin=False)
        else:
            library = res["library_ms"] = res["library_ms_host"] = None
        if cold:
            res["ms_cold"] = _time_ms(lambda: flash_prefill(
                q, k, v, lens, sliding_window=window), cold=True)
            res["library_ms_cold"] = _time_ms(library, cold=True) \
                if library else None
    log(name + " " + json.dumps(res))
    return res


def check_decode(B, H, KVH, T, D, dtype, lengths, q8=False, window=None,
                 timed=True, cold=False):
    """With timed=True also plants a fault — the last 32-token tile dropped
    from each row longer than 512, where one tile moves the output least —
    and checks that the tolerance rejects it. cold=True also times kernel
    and library with a cold L2."""
    import torch
    import torch.nn.functional as F

    from localai_tpu_torch.ops.kernels import (
        ragged_decode, ragged_decode_plain, ragged_decode_q8,
        ragged_decode_q8_plain,
    )

    case = _decode_case(B, H, KVH, T, D, dtype, lengths, q8=q8)
    kernel, plain_fn = (ragged_decode_q8, ragged_decode_q8_plain) if q8 \
        else (ragged_decode, ragged_decode_plain)
    fn = lambda: kernel(*case, sliding_window=window)  # noqa: E731
    plain = lambda: plain_fn(*case, sliding_window=window)  # noqa: E731
    out = fn()
    torch.cuda.synchronize()
    ref = plain()
    fault = None
    if timed:
        short = torch.tensor([n - 32 if n > 512 else n for n in lengths],
                             dtype=torch.int32, device="cuda")
        fault = plain_fn(*case[:-1], short, sliding_window=window)
    kname = "ragged_decode_q8" if q8 else "ragged_decode"
    name = f"{kname} {str(dtype).split('.')[-1]} B={B} T={T} H={H} " \
           f"KVH={KVH} D={D} lengths={lengths[:8]}{'...' if B > 8 else ''}" \
           f" window={window}"
    res = _check_close(name, out, ref, TOL[str(dtype).split(".")[-1]],
                       fault=fault)
    if timed:
        es = case[0].element_size()
        read = sum(min(n, T) if not window else min(n, T, window)
                   for n in lengths)
        kv_es = 1 if q8 else es
        # K/V (and int8 scales) of the tokens read, q and out, lengths
        nbytes = (read * KVH * D * 2 * kv_es + (read * KVH * 2 * 4 if q8
                                                else 0)
                  + 2 * B * H * D * es + 4 * B)
        flops = 4.0 * read * H * D
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        res.update(ms=_time_ms(fn), ms_host=_time_ms(fn, spin=False),
                   ms_graph=_graph_ms(fn), plain_ms=_time_ms(plain),
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   bound_formula=(f"max({nbytes:.4g} B of K/V read + q/out "
                                  f"/ 3.35 TB/s, {flops:.4g} flop / "
                                  f"{peak / 1e12:.0f} TFLOP/s)"))
        if not q8 and window is None:
            q, k, v, lens = case
            qt = q.transpose(1, 2)                        # [B, H, 1, D]
            mask = (torch.arange(T, device="cuda")[None, :]
                    < lens[:, None])[:, None, None, :]   # [B, 1, 1, T]

            def library():
                return F.scaled_dot_product_attention(
                    qt, k, v, attn_mask=mask, enable_gqa=True)
            res["library_ms"] = _time_ms(library)
            res["library_ms_host"] = _time_ms(library, spin=False)
        else:
            library = res["library_ms"] = res["library_ms_host"] = None
        if cold:
            res["ms_cold"] = _time_ms(fn, cold=True)
            res["library_ms_cold"] = _time_ms(library, cold=True) \
                if library else None
    log(name + " " + json.dumps(res))
    return res


def _paged_pools(B, KVH, D, lengths, maxb, seed=0, nb=0):
    """K/V block pools [NB, KVH, 128, D] (f32, random) and a shuffled,
    non-contiguous table [B, maxb]: slot b's ceil(len/128) blocks are drawn
    from a random permutation of blocks 1..NB-1, its entries past the
    allocation are 0 (the trash block). NB is at least `nb` and leaves room
    for the identity map of the planted fault (blocks 1..maxb)."""
    import torch

    alloc = [-(-n // 128) for n in lengths]
    nb = max(sum(alloc) + 1, maxb + 1, nb)
    g = torch.Generator(device="cuda").manual_seed(seed)
    k = torch.randn(nb, KVH, 128, D, device="cuda", generator=g)
    v = torch.randn(nb, KVH, 128, D, device="cuda", generator=g)
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(
        seed)) + 1
    table = torch.zeros(B, maxb, dtype=torch.int32)
    used = 0
    for b, a in enumerate(alloc):
        table[b, :a] = perm[used:used + a]
        used += a
    return k, v, table.cuda(), nb


def _q8_paged_fault_l_scaled(q, kq, ks, vq, vs, lens, window, table):
    """A planted fault of the int8 paged decode: the plain version with the
    V scale applied to l as well (l sums p * Sv where the kernel's contract
    sums the unscaled p)."""
    import torch

    from localai_tpu_torch.ops.attention import NEG_INF
    from localai_tpu_torch.ops.kvcache import QuantKV
    from localai_tpu_torch.ops.paged import paged_view

    kv, vv = paged_view(QuantKV(kq, ks), table), paged_view(QuantKV(vq, vs),
                                                             table)
    B, _, H, D = q.shape
    KVH, T = kv.q.shape[1], kv.q.shape[2]
    qg = (q.float() * D ** -0.5).reshape(B, KVH, H // KVH, D)
    s = torch.einsum("bkgd,bktd->bkgt", qg, kv.q.float()) \
        * kv.s.float().reshape(B, KVH, 1, T)
    pos = torch.arange(T, device=q.device)
    mask = pos[None, :] < lens[:, None]
    if window:
        mask = mask & (pos[None, :] >= lens[:, None] - window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    pv = p * vv.s.float().reshape(B, KVH, 1, T)
    o = torch.einsum("bkgt,bktd->bkgd", pv, vv.q.float()) \
        / torch.clamp_min(pv.sum(dim=-1, keepdim=True), 1e-30)
    return o.reshape(B, 1, H, D).to(q.dtype)


def check_paged_decode(B, H, KVH, D, dtype, lengths, maxb, q8=False,
                       window=None, timed=True, nb=0, cold=False):
    """Paged decode (kernels 3 and 5, split-KV) against its plain version
    (paged_view then the dense plain version), over a pool of at least `nb`
    blocks; reports the spans (nsplit, split) and ring stages the kernel
    launches with. With timed=True also plants a fault — the plain version
    reads the identity map (blocks 1..maxb for every slot) instead of the
    table; int8 also the V scale applied to l — and checks that the
    tolerance rejects it. cold=True also times the kernel with a cold
    L2."""
    import torch

    from localai_tpu_torch.ops.kernels import (
        _build, decode_split, ragged_decode, ragged_decode_plain,
        ragged_decode_q8, ragged_decode_q8_plain,
    )
    from localai_tpu_torch.ops.kernels.flash_attention import _DTYPE_CODE
    from localai_tpu_torch.ops.kvcache import quantize_tokens

    k, v, table, nb = _paged_pools(B, KVH, D, lengths, maxb, nb=nb)
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(B, 1, H, D, device="cuda", generator=g).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    if q8:
        kq, ks = quantize_tokens(k)
        vq, vs = quantize_tokens(v)
        pools = (kq, ks.reshape(nb, KVH, 1, 128), vq,
                 vs.reshape(nb, KVH, 1, 128))
        kernel, plain_fn = ragged_decode_q8, ragged_decode_q8_plain
    else:
        pools = (k.to(dtype), v.to(dtype))
        kernel, plain_fn = ragged_decode, ragged_decode_plain
    fn = lambda: kernel(q, *pools, lens, sliding_window=window,  # noqa: E731
                        table=table)
    plain = lambda: plain_fn(q, *pools, lens,  # noqa: E731
                             sliding_window=window, table=table)
    out = fn()
    torch.cuda.synchronize()
    ref = plain()
    fault = None
    kname = "ragged_decode_q8 paged" if q8 else "ragged_decode paged"
    name = f"{kname} {str(dtype).split('.')[-1]} B={B} MAXB={maxb} " \
           f"NB={nb} H={H} KVH={KVH} D={D} " \
           f"lengths={lengths[:8]}{'...' if B > 8 else ''} window={window}"
    tol = TOL[str(dtype).split(".")[-1]]
    if timed:
        ident = (torch.arange(maxb, dtype=torch.int32, device="cuda")
                 + 1).expand(B, maxb).contiguous()
        fault = plain_fn(q, *pools, lens, sliding_window=window, table=ident)
    res = _check_close(name, out, ref, tol, fault=fault)
    if timed and q8:
        res["planted_fault_l_scaled_err"] = _check_close(
            name + " (V scale in l)", out, ref, tol,
            fault=_q8_paged_fault_l_scaled(q, *pools, lens, window,
                                           table))["planted_fault_err"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res["nsplit"], res["split"] = decode_split(maxb * 128, B * KVH, sms)
    res["stages"] = _build.load("decode_attention").decode_split_stages(
        _DTYPE_CODE[dtype], int(q8))
    if timed:
        es = q.element_size()
        read = sum(min(n, maxb * 128) if not window
                   else min(n, maxb * 128, window) for n in lengths)
        kv_es = 1 if q8 else es
        entries = sum(-(-n // 128) for n in lengths)
        # K/V (and int8 scales) of the tokens read, the table entries read,
        # q and out, lengths
        nbytes = (read * KVH * D * 2 * kv_es + (read * KVH * 2 * 4 if q8
                                                else 0)
                  + 4 * entries + 2 * B * H * D * es + 4 * B)
        flops = 4.0 * read * H * D
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        res.update(ms=_time_ms(fn), ms_host=_time_ms(fn, spin=False),
                   ms_graph=_graph_ms(fn), plain_ms=_time_ms(plain),
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   bound_formula=(f"max({nbytes:.4g} B of K/V + table read "
                                  f"+ q/out / 3.35 TB/s, {flops:.4g} flop / "
                                  f"{peak / 1e12:.0f} TFLOP/s)"),
                   library_ms=None, library_ms_host=None,
                   library_note="no single PyTorch call attends through a "
                                "block table")
        if cold:
            res["ms_cold"] = _time_ms(fn, cold=True)
    log(name + " " + json.dumps(res))
    return res


def check_paged_scatter(B, KVH, D, dtype, q8=False, nb=129, maxb=32):
    """Scatter-append (kernels 6 and 7) against its plain version: the
    pools after the kernel must equal the pools after the plain version BIT
    FOR BIT, trash block included, and every byte outside the targets must
    equal a clone taken before. Inactive slots (every third) go to the
    trash block. The planted fault (the plain version writing row off+1)
    must differ."""
    import torch

    from localai_tpu_torch.ops.kernels import (
        paged_scatter_append, paged_scatter_append_plain,
        paged_scatter_append_q8, paged_scatter_append_q8_plain,
        paged_targets,
    )
    from localai_tpu_torch.ops.kvcache import quantize_tokens

    lengths = [(97 * b + 1) % (maxb * 128 - 1) for b in range(B)]
    k, v, table, nb = _paged_pools(B, KVH, D, [n + 1 for n in lengths],
                                   maxb, seed=2, nb=nb)
    g = torch.Generator(device="cuda").manual_seed(3)
    k_new = torch.randn(B, KVH, D, device="cuda", generator=g).to(dtype)
    v_new = torch.randn(B, KVH, D, device="cuda", generator=g).to(dtype)
    pos = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    active = torch.tensor([b % 3 != 2 for b in range(B)], device="cuda")
    targets = paged_targets(pos, table, active)
    if q8:
        kq, ks = quantize_tokens(k)
        vq, vs = quantize_tokens(v)
        pools = [kq, ks.reshape(nb, KVH, 1, 128), vq,
                 vs.reshape(nb, KVH, 1, 128)]
        kernel, plain_fn = paged_scatter_append_q8, \
            paged_scatter_append_q8_plain
    else:
        pools = [k.to(dtype), v.to(dtype)]
        kernel, plain_fn = paged_scatter_append, paged_scatter_append_plain
    before = [t.clone() for t in pools]
    ref = [t.clone() for t in pools]
    kernel(*pools, k_new, v_new, pos, table, active, targets=targets)
    torch.cuda.synchronize()
    plain_fn(*ref, k_new, v_new, pos, table, active, targets=targets)
    pb, off = (t.long() for t in targets)
    # rows of a pool: [NB, KVH, 128, D] as is, a scale pool [NB, KVH, 1,
    # 128] as [NB, KVH, 128]; `keep` marks every row but the targets
    keep = torch.ones(nb, KVH, 128, dtype=torch.bool, device="cuda")
    keep[pb, :, off] = False

    def rows(t):
        return t[:, :, 0] if t.shape[2] == 1 else t

    for i, (got, want, old) in enumerate(zip(pools, ref, before)):
        if not torch.equal(got, want):
            raise AssertionError(f"paged scatter pool {i}: kernel and plain "
                                 f"version differ")
        if not torch.equal(rows(got)[keep], rows(old)[keep]):
            raise AssertionError(f"paged scatter pool {i}: a byte outside "
                                 f"the targets changed")
    fault = [t.clone() for t in before]
    plain_fn(*fault, k_new, v_new, pos, table, active,
             targets=(targets[0], (targets[1] + 1) % 128))
    if all(torch.equal(a, b) for a, b in zip(fault, pools)):
        raise AssertionError("paged scatter: the check does not reject the "
                             "planted fault")
    kname = "paged_scatter_append_q8" if q8 else "paged_scatter_append"
    name = f"{kname} {str(dtype).split('.')[-1]} B={B} NB={nb} KVH={KVH} " \
           f"D={D}"
    res = {"max_abs_err": 0.0, "tol": "bit-exact",
           "planted_fault_differs": True}
    es = k_new.element_size()
    # in: the new K/V rows and the targets (one table entry and one offset
    # per slot); out: the rows written (int8: plus one f32 scale per row)
    out_es = 1 if q8 else es
    nbytes = (2 * B * KVH * D * es + 8 * B + 2 * B * KVH * D * out_es
              + (2 * B * KVH * 4 if q8 else 0))
    res.update(
        ms=_time_ms(lambda: kernel(*pools, k_new, v_new, pos, table, active,
                                   targets=targets)),
        ms_host=_time_ms(lambda: kernel(*pools, k_new, v_new, pos, table,
                                        active, targets=targets),
                         spin=False),
        ms_graph=_graph_ms(lambda: kernel(*pools, k_new, v_new, pos, table,
                                          active, targets=targets)),
        plain_ms=_time_ms(lambda: plain_fn(*ref, k_new, v_new, pos, table,
                                           active, targets=targets)),
        bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
        bound_formula=f"{nbytes} B / 3.35 TB/s")
    if q8:
        # the function quantizes each row and writes int8 rows plus their
        # scales: no single PyTorch call does that (the plain version is
        # the PyTorch composition of it)
        res.update(library_ms=None, library_ms_host=None,
                   library_note="no single PyTorch call quantizes rows and "
                                "scatters them with their scales")
    else:
        def library():
            pools[0][pb, :, off] = k_new
            pools[1][pb, :, off] = v_new
        res.update(library_ms=_time_ms(library),
                   library_ms_host=_time_ms(library, spin=False),
                   library_note="pool[pb, :, off] = row (index_put_) for the "
                                "K and the V pool")
    log(name + " " + json.dumps(res))
    return res


# phase 6's ragged pack: the eight decode rows at phase 5's lengths beside
# one 128-row chunk at offset 1024 of a 1500-token prompt (T = 8*8 + 128)
RAGGED_DECODE = [33, 49, 332, 732, 1532, 672, 712, 4095]
RAGGED_CHUNK = (1024, 128)


def _ragged_seqs(decode_lens, chunk):
    """(kvlen, qlen) of each sequence of the pack: one decode row per entry
    of decode_lens at that kv length, then the (offset, rows) prefill chunk
    (none for chunk=None)."""
    seqs = [(n, 1) for n in decode_lens]
    if chunk is not None:
        seqs.append((chunk[0] + chunk[1], chunk[1]))
    return seqs


def _ragged_pack(decode_lens, chunk, maxb, nb, KVH, D, seed=0, seqs=None):
    """A flat stream of the sequences `seqs` — (kvlen, qlen) each, or None
    for a dead q block (block_seq -1) at that place — in stream order, each
    from an 8-aligned row (by default _ragged_seqs(decode_lens, chunk)).
    Pools and a shuffled table as _paged_pools makes them. Returns (k, v,
    meta dict of int32 CUDA tensors, live rows, kvlens, nb)."""
    import torch

    if seqs is None:
        seqs = _ragged_seqs(decode_lens, chunk)
    kvlens = [x[0] for x in seqs if x is not None]
    k, v, table, nb = _paged_pools(len(kvlens), KVH, D, kvlens, maxb,
                                   seed=seed, nb=nb)
    block_seq, qstart, qlens, live, row = [], [], [], [], 0
    for x in seqs:
        if x is None:
            block_seq.append(-1)
            row += 8
            continue
        ql = x[1]
        block_seq += [len(qstart)] * -(-ql // 8)
        qstart.append(row)
        qlens.append(ql)
        live += list(range(row, row + ql))
        row += -(-ql // 8) * 8

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device="cuda")

    meta = dict(block_seq=i32(block_seq), qstart=i32(qstart),
                qlen=i32(qlens), kvlen=i32(kvlens), tables=table)
    return k, v, meta, live, kvlens, nb


def check_ragged_attention(H, KVH, D, dtype, decode_lens, chunk, maxb,
                           q8=False, window=None, nb=0, seqs=None,
                           cold=False):
    """Ragged paged attention (kernels 8 and 9, split-KV) against its plain
    version on the live rows of the pack (padding rows are garbage by
    contract; the kernel writes 0 there, which is checked too). Plants two
    faults that the tolerance must reject: the plain version reading the
    identity map (blocks 1..maxb for every sequence) instead of the table,
    and the plain version with each sequence's kvlen cut back to the start
    of its last span (a dropped split). Reports the spans, the tiling the
    .cu launches with, and the CUDA launches of one call (the split pass
    and the combine)."""
    import torch

    from localai_tpu_torch.ops.kernels import (
        _build, launch_counts, ragged_paged_attention,
        ragged_paged_attention_plain, ragged_paged_attention_q8,
        ragged_paged_attention_q8_plain, ragged_split, ragged_tiling,
    )
    from localai_tpu_torch.ops.kernels.flash_attention import _DTYPE_CODE
    from localai_tpu_torch.ops.kvcache import quantize_tokens

    if seqs is None:
        seqs = _ragged_seqs(decode_lens, chunk)
    k, v, meta, live, kvlens, nb = _ragged_pack(None, None, maxb, nb, KVH,
                                                D, seed=4, seqs=seqs)
    T = int(meta["block_seq"].shape[0]) * 8
    g = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(T, H, D, device="cuda", generator=g).to(dtype)
    if q8:
        kq, ks = quantize_tokens(k)
        vq, vs = quantize_tokens(v)
        pools = (kq, ks.reshape(nb, KVH, 1, 128), vq,
                 vs.reshape(nb, KVH, 1, 128))
        kernel = ragged_paged_attention_q8
        plain_fn = ragged_paged_attention_q8_plain
    else:
        pools = (k.to(dtype), v.to(dtype))
        kernel, plain_fn = ragged_paged_attention, ragged_paged_attention_plain
    fn = lambda: kernel(q, *pools, **meta,  # noqa: E731
                        sliding_window=window)
    plain = lambda: plain_fn(q, *pools, **meta,  # noqa: E731
                             sliding_window=window)
    kname = "ragged_paged_attention_q8" if q8 else "ragged_paged_attention"
    before = launch_counts()[kname]
    out = fn()
    torch.cuda.synchronize()
    if launch_counts()[kname] != before + 1:
        raise AssertionError(f"{kname}: one call did not count one launch")
    ref = plain()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    nsplit, split = ragged_split(T, maxb, KVH, sms)
    n_seq = len(kvlens)
    ident = (torch.arange(maxb, dtype=torch.int32, device="cuda")
             + 1).expand(n_seq, maxb).contiguous()
    fault = plain_fn(q, *pools, **dict(meta, tables=ident),
                     sliding_window=window)
    dropped = plain_fn(q, *pools, **dict(
        meta, kvlen=((meta["kvlen"] - 1) // split * split).to(torch.int32)),
        sliding_window=window)
    rows = torch.tensor(live, device="cuda")
    dead = sorted(set(range(T)) - set(live))
    if dead and bool(out[torch.tensor(dead, device="cuda")].float().abs()
                     .max() != 0):
        raise AssertionError(f"{kname}: a row outside every span is not 0")
    desc = ",".join("dead" if x is None else f"{x[0]}/{x[1]}" for x in seqs)
    name = (f"{kname} {str(dtype).split('.')[-1]} T={T} MAXB={maxb} NB={nb} "
            f"H={H} KVH={KVH} D={D} kvlen/qlen=[{desc}] window={window}")
    tol = TOL[str(dtype).split(".")[-1]]
    res = _check_close(name, out[rows], ref[rows], tol, fault=fault[rows])
    res["planted_fault_dropped_split_err"] = _check_close(
        name + " (dropped split)", out[rows], ref[rows], tol,
        fault=dropped[rows])["planted_fault_err"]
    tc = dtype == torch.bfloat16 and D <= 256
    tiling = _build.load("ragged_attention").ragged_attention_tiling(
        _DTYPE_CODE[dtype], H // KVH, D)
    if (tiling >> 16, tiling & 0xFFFF) != ragged_tiling(H // KVH, D, tc):
        raise AssertionError(f"{kname}: the .cu's tiling {tiling} is not "
                             f"ragged_tiling's")
    res.update(nsplit=nsplit, split=split, gc=tiling >> 16,
               qt=tiling & 0xFFFF, route="tensor cores" if tc else "SIMT",
               launches=1, cuda_launches=2)
    # the work this pack needs: each live row attends to keys up to its
    # position (within the window); each sequence's K/V below its length
    # (from its first live row's window start) is read once, with q and
    # out of the live rows and the table entries
    es = q.element_size()
    kv_es = 1 if q8 else es
    pairs, kv_read, entries = 0, 0, 0
    for kvl, ql in (x for x in seqs if x is not None):
        first = kvl - ql
        lo = max(first - window + 1, 0) if window else 0
        kv_read += kvl - lo
        entries += -(-kvl // 128) - lo // 128
        pairs += sum(min(p + 1, window or p + 1) for p in range(first, kvl))
    nbytes = (kv_read * KVH * D * 2 * kv_es
              + (kv_read * KVH * 2 * 4 if q8 else 0)
              + 2 * len(live) * H * D * es + 4 * entries)
    flops = 4.0 * pairs * H * D
    peak = PEAK_F32 if dtype == torch.float32 else PEAK_BF16
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    res.update(ms=_time_ms(fn), ms_host=_time_ms(fn, spin=False),
               ms_graph=_graph_ms(fn), plain_ms=_time_ms(plain),
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               bound_formula=(f"max({nbytes:.4g} B of unique K/V + live q/out "
                              f"+ table / 3.35 TB/s, {flops:.4g} causal flop "
                              f"/ {peak / 1e12:.0f} TFLOP/s)"),
               library_ms=None, library_ms_host=None,
               library_note="no single PyTorch call attends a flat stream "
                            "through block tables")
    if cold:
        res["ms_cold"] = _time_ms(fn, cold=True)
    log(name + " " + json.dumps(res))
    return res


def check_ragged_scatter(KVH, D, dtype, decode_lens, chunk, maxb, q8=False,
                         nb=0, seqs=None):
    """Flat-row scatter (kernels 10 and 11) at the pack's own targets
    (models/llama.ragged_row_targets: live rows at their positions through
    the table, padding rows to the trash block at row % 128, colliding
    there when T > 128). Outside block 0 the pools after the kernel must
    equal the pools after the plain version BIT FOR BIT, and every row
    outside the live targets must equal a clone taken before; the planted
    fault (live rows written at off+1) must differ."""
    import torch

    from localai_tpu_torch.models.llama import ragged_row_targets
    from localai_tpu_torch.ops.kernels import (
        ragged_scatter_append, ragged_scatter_append_plain,
        ragged_scatter_append_q8, ragged_scatter_append_q8_plain,
    )
    from localai_tpu_torch.ops.kvcache import quantize_tokens

    k, v, meta, live, _, nb = _ragged_pack(decode_lens, chunk, maxb, nb,
                                           KVH, D, seed=6, seqs=seqs)
    T = int(meta["block_seq"].shape[0]) * 8
    _, pb, off = ragged_row_targets(meta["block_seq"], meta["qstart"],
                                    meta["qlen"], meta["kvlen"],
                                    meta["tables"], maxb * 128)
    g = torch.Generator(device="cuda").manual_seed(7)
    k_new = torch.randn(T, KVH, D, device="cuda", generator=g).to(dtype)
    v_new = torch.randn(T, KVH, D, device="cuda", generator=g).to(dtype)
    if q8:
        kq, ks = quantize_tokens(k)
        vq, vs = quantize_tokens(v)
        pools = [kq, ks.reshape(nb, KVH, 1, 128), vq,
                 vs.reshape(nb, KVH, 1, 128)]
        kernel = ragged_scatter_append_q8
        plain_fn = ragged_scatter_append_q8_plain
    else:
        pools = [k.to(dtype), v.to(dtype)]
        kernel, plain_fn = ragged_scatter_append, ragged_scatter_append_plain
    before = [t.clone() for t in pools]
    ref = [t.clone() for t in pools]
    kernel(*pools, k_new, v_new, pb, off)
    torch.cuda.synchronize()
    plain_fn(*ref, k_new, v_new, pb, off)
    rows = torch.tensor(live, device="cuda")
    lpb, loff = pb.long()[rows], off.long()[rows]
    keep = torch.ones(nb, KVH, 128, dtype=torch.bool, device="cuda")
    keep[lpb, :, loff] = False
    keep[0] = False                       # the trash block: a benign race

    def body(t):
        return t[:, :, 0] if t.shape[2] == 1 else t

    for i, (got, want, old) in enumerate(zip(pools, ref, before)):
        if not torch.equal(got[1:], want[1:]):
            raise AssertionError(f"ragged scatter pool {i}: kernel and "
                                 f"plain version differ outside block 0")
        if not torch.equal(body(got)[keep], body(old)[keep]):
            raise AssertionError(f"ragged scatter pool {i}: a row outside "
                                 f"the targets changed")
    fault = [t.clone() for t in before]
    plain_fn(*fault, k_new, v_new, pb, torch.where(
        pb > 0, (off + 1) % 128, off).to(torch.int32))
    if all(torch.equal(a[1:], b[1:]) for a, b in zip(fault, pools)):
        raise AssertionError("ragged scatter: the check does not reject "
                             "the planted fault")
    kname = "ragged_scatter_append_q8" if q8 else "ragged_scatter_append"
    name = (f"{kname} {str(dtype).split('.')[-1]} T={T} NB={nb} KVH={KVH} "
            f"D={D}")
    res = {"max_abs_err": 0.0, "tol": "bit-exact outside block 0",
           "planted_fault_differs": True}
    es = k_new.element_size()
    n = len(live)
    # in: the live rows and their targets; out: the rows written (int8:
    # plus one f32 scale per row and head)
    out_es = 1 if q8 else es
    nbytes = (2 * n * KVH * D * es + 8 * n + 2 * n * KVH * D * out_es
              + (2 * n * KVH * 4 if q8 else 0))
    res.update(
        ms=_time_ms(lambda: kernel(*pools, k_new, v_new, pb, off)),
        ms_graph=_graph_ms(lambda: kernel(*pools, k_new, v_new, pb, off)),
        ms_host=_time_ms(lambda: kernel(*pools, k_new, v_new, pb, off),
                         spin=False),
        plain_ms=_time_ms(lambda: plain_fn(*ref, k_new, v_new, pb, off)),
        bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
        bound_formula=f"{nbytes} B / 3.35 TB/s")
    if q8:
        res.update(library_ms=None, library_ms_host=None,
                   library_note="no single PyTorch call quantizes rows and "
                                "scatters them with their scales")
    else:
        pbl, offl = pb.long(), off.long()

        def library():
            pools[0][pbl, :, offl] = k_new
            pools[1][pbl, :, offl] = v_new
        res.update(library_ms=_time_ms(library),
                   library_ms_host=_time_ms(library, spin=False),
                   library_note="pool[pb, :, off] = row (index_put_) for the "
                                "K and the V pool")
    log(name + " " + json.dumps(res))
    return res


def ragged_packs(H, KVH, D):
    """Split-KV ragged attention (rows 8 and 9) at the packs that exercise
    its work split, each against the plain version with both planted
    faults, timed warm, cold and with the host's cost: one 4095-token
    decode row; one 256-row chunk at offset 3840 (kvlen = MAXB*128); dead
    q blocks between live sequences; kv lengths exactly at a span boundary
    and at MAXB*128; phase 6's pack with a window whose start falls inside
    a span; G = 16 (H=128, KVH=8); then head_dim 256 and 512 on a small
    pack (f32 and bf16; 512 takes the SIMT variant)."""
    import torch

    from localai_tpu_torch.ops.kernels import ragged_split

    bf16, f32 = torch.bfloat16, torch.float32
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def split_of(seqs, maxb=32):
        rows = sum(8 if x is None else -(-x[1] // 8) * 8 for x in seqs)
        return ragged_split(rows, maxb, KVH, sms)[1]

    main_seqs = _ragged_seqs(RAGGED_DECODE, RAGGED_CHUNK)
    bnd = [(1, 1), (1, 1), (4096, 1), (1, 1), (4096, 64)]
    sp = split_of(bnd)
    bnd[0], bnd[1], bnd[3] = (sp, 1), (sp + 1, 1), (2 * sp, 1)
    packs = {
        "one 4095-token decode row": dict(seqs=[(4095, 1)]),
        "256-row chunk at offset 3840": dict(seqs=[(4096, 256)]),
        "dead q blocks between live ones": dict(
            seqs=[(700, 1), None, (1500, 1), None, (1152, 128), None]),
        f"kvlen at the span boundary {sp} and at 4096": dict(seqs=bnd),
        "phase 6 pack, window start inside a span": dict(
            seqs=main_seqs, window=split_of(main_seqs) + 7),
        "phase 6 pack, G=16 (H=128, KVH=8)": dict(seqs=main_seqs, H=128),
    }
    summary = {}
    for label, kw in packs.items():
        h = kw.pop("H", H)
        for q8 in (False, True):
            r = check_ragged_attention(h, KVH, D, bf16, None, None, 32,
                                       q8=q8, nb=129, cold=True, **kw)
            summary[label + (" int8" if q8 else " bf16")] = {
                f: r.get(f) for f in (
                    "ms", "ms_cold", "ms_host", "bound_ms", "plain_ms",
                    "launches", "cuda_launches", "nsplit", "split", "gc",
                    "qt", "max_abs_err", "planted_fault_err",
                    "planted_fault_dropped_split_err")}
    small = [(5, 1), (200, 1), (300, 1), (136, 40)]
    for d in (256, 512):
        for dt in (f32, bf16):
            r = check_ragged_attention(8, 2, d, dt, None, None, 4,
                                       seqs=small, window=100)
            summary[f"small pack D={d} {str(dt).split('.')[-1]}"] = {
                f: r.get(f) for f in ("ms", "bound_ms", "route", "nsplit",
                                      "split", "max_abs_err",
                                      "planted_fault_err",
                                      "planted_fault_dropped_split_err")}
    log("phase2 ragged packs " + json.dumps(summary))


# w8a16_matmul vs plain: 2 bf16 steps an output — the sum and the scaled
# product each round once, and another summation order can move either by
# a step — and at most 1% of the outputs different at all: another order
# flips about one rounding in 10^4, a scale applied before the rounding
# about a third (each by the same steps, so only the share rejects it).
# f32: sums over K up to 14336 of products up to 127 in another order.
W8_TOL = {"bfloat16": (1e-3, 2 ** -6), "float32": (5e-5, 2 ** -16)}
W8_SHARE = 0.01
# head_matmul vs plain: f32 logits of magnitude ~1, sums over K = 4096 in
# another order (tensor-core sums for the int8 head); rounding x32 to bf16
# on a bf16 head moves them by ~1e-3
HEAD_TOL = (1e-4, 0.0)
# the 8B projections (K, N): wq/wo, wk/wv, w_gate/w_up, w_down
W8_GEOMETRIES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
# Qwen2-7B's (phase 6 serves it in int8): wq/wo, wk/wv, gate/up, down
W8_GEOMETRIES_QWEN2 = [(3584, 3584), (3584, 512), (3584, 18944),
                       (18944, 3584)]
# the row-13 table's M: decode, phase 6's pack, a prefill batch
W8_ROWS = (4, 192, 2048)


def _int8_weight(K, N, g):
    """An N(0, 1/K) weight [K, N] on the card, int8-quantized
    (QuantWeight)."""
    import torch

    from localai_tpu_torch.ops.quant import quantize

    return quantize(torch.randn(K, N, device="cuda", generator=g)
                    * K ** -0.5)


def _timings(fn, plain, library, nbytes, flops, peak, cold, **extra):
    """The readings of one timed case: kernel, plain and library device
    times (library also host-inclusive), the in-graph reading, cold L2
    readings with `cold`, and bound_ms; `extra` names more library calls,
    each timed warm (and cold)."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    res = dict(
        ms=_time_ms(fn), ms_host=_time_ms(fn, spin=False),
        ms_graph=_graph_ms(fn), plain_ms=_time_ms(plain),
        library_ms=_time_ms(library),
        library_ms_host=_time_ms(library, spin=False),
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        bound_formula=(f"max({nbytes:.4g} B / 3.35 TB/s, {flops:.4g} flop "
                       f"/ {peak / 1e12:.0f} TFLOP/s)"))
    for k, f in extra.items():
        res[k] = _time_ms(f) if f else None
    if cold:
        res["ms_cold"] = _time_ms(fn, cold=True)
        res["library_ms_cold"] = _time_ms(library, cold=True)
        for k, f in extra.items():
            res[k.replace("_ms", "_ms_cold")] = _time_ms(f, cold=True) \
                if f else None
    return res


def check_w8a16(M, K, N, dtype, timed=True, cold=True, seed=0):
    """w8a16_matmul at x [M, K] @ int8 [K, N]. With timed=True also plants
    three faults — the 64 K rows 64..127 of the weight dropped, the same
    rows replaced by rows 0..63 (a ring stage read before its load
    landed: the stage's previous tile), and (bf16) the scale applied to
    the f32 sum before the rounding — and checks that the limit rejects
    each. library_ms: the two calls it replaces, the
    weight's cast and torch.matmul; library_bf16_ms: torch.matmul on a
    bf16 weight made beforehand (what the bf16 recipe pays)."""
    import torch

    from localai_tpu_torch.ops.kernels import w8a16_matmul, \
        w8a16_matmul_plain

    g = torch.Generator(device="cuda").manual_seed(seed + M + K + N)
    qw = _int8_weight(K, N, g)
    q, s = qw.q, qw.s
    x = torch.randn(M, K, device="cuda", generator=g).to(dtype)
    fn = lambda: w8a16_matmul(x, q, s)  # noqa: E731
    plain = lambda: w8a16_matmul_plain(x, q, s)  # noqa: E731
    out = fn()
    torch.cuda.synchronize()
    ref = plain()
    dt = str(dtype).split(".")[-1]
    faults = {}
    if timed:
        qd = q.clone()
        qd[64:128] = 0
        faults["k_tile_dropped"] = w8a16_matmul_plain(x, qd, s)
        # a ring stage read before its load landed: K tile 1 holds tile 0
        qd[64:128] = q[:64]
        faults["stage_before_load"] = w8a16_matmul_plain(x, qd, s)
        if dtype != torch.float32:
            faults["scale_before_rounding"] = (
                (x.float() @ q.float()) * s).to(dtype)
    name = f"w8a16_matmul {dt} M={M} K={K} N={N}"
    res = _check_close(name, out, ref, W8_TOL[dt], fault=faults or None,
                       share=None if dtype == torch.float32 else W8_SHARE)
    if timed:
        es = x.element_size()
        wb = q.to(dtype)
        res.update(_timings(
            fn, plain, lambda: torch.matmul(x, q.to(dtype)),
            nbytes=K * N + M * K * es + M * N * es + 4 * N,
            flops=2.0 * M * K * N,
            peak=PEAK_F32 if dtype == torch.float32 else PEAK_BF16,
            cold=cold, library_bf16_ms=None if dtype == torch.float32
            else (lambda: torch.matmul(x, wb))))
    log(name + " " + json.dumps(res))
    return res


def check_head(M, K, V, kind, timed=True, cold=True, seed=0):
    """head_matmul at x32 [M, K] f32 against a [K, V] head: bf16, int8
    (q, s) or a tied bf16 embedding [V, K] passed as embed.T. Planted
    fault: x32 rounded to bf16 (bf16 and tied), the K rows 64..127
    dropped (int8). library_ms: the f32 copy of the head and
    torch.matmul."""
    import torch

    from localai_tpu_torch.ops.kernels import head_matmul, head_matmul_plain

    g = torch.Generator(device="cuda").manual_seed(seed + M + K + V)
    x32 = torch.randn(M, K, device="cuda", generator=g)
    if kind == "int8":
        qw = _int8_weight(K, V, g)
        args = (qw.q, qw.s)
    else:
        w = (torch.randn(V, K, device="cuda", generator=g)
             * K ** -0.5).to(torch.bfloat16)
        args = (w.T,) if kind == "tied" else (w.T.contiguous(),)
    fn = lambda: head_matmul(x32, *args)  # noqa: E731
    plain = lambda: head_matmul_plain(x32, *args)  # noqa: E731
    out = fn()
    torch.cuda.synchronize()
    ref = plain()
    if kind == "int8":
        qd = args[0].clone()
        qd[64:128] = 0
        fault = {"k_tile_dropped": head_matmul_plain(x32, qd, args[1])}
    else:
        fault = {"x32_rounded_to_bf16": head_matmul_plain(
            x32.to(torch.bfloat16).float(), *args)}
    name = f"head_matmul {kind} M={M} K={K} V={V}"
    res = _check_close(name, out, ref, HEAD_TOL,
                       fault=fault if timed else None)
    if timed:
        wbytes = K * V * (1 if kind == "int8" else 2)
        res.update(_timings(
            fn, plain, lambda: x32 @ args[0].float(),
            nbytes=wbytes + (4 * V if kind == "int8" else 0) + M * K * 4
            + M * V * 4, flops=2.0 * M * K * V,
            peak=PEAK_BF16 if kind == "int8" else PEAK_F32, cold=cold))
    log(name + " " + json.dumps(res))
    return res


def weight_gemms():
    """Rows 13 and 14 of PERF.md §6 at every 8B projection geometry for
    M = 4, 8, 16 (decode), 17 (the first on the wgmma route), 192 (phase
    6's pack) and 2048 (a prefill batch) and at Qwen2-7B's geometries for
    M = 4, 192 and 2048, in bf16, and one f32 case; the heads of
    Llama-3.1-8B (bf16, int8, tied) at M = 4 and 8 and of Qwen2-7B at M =
    4. Returns the main rows: M = 4 on w_gate, and the bf16 head at M =
    4."""
    import torch

    w8 = {f"M={M} K={K} N={N}": check_w8a16(M, K, N, torch.bfloat16)
          for K, N in W8_GEOMETRIES for M in (4, 8, 16, 17, 192, 2048)}
    for K, N in W8_GEOMETRIES_QWEN2:
        for M in W8_ROWS:
            w8[f"qwen2-7b M={M} K={K} N={N}"] = check_w8a16(
                M, K, N, torch.bfloat16, cold=False)
    w8["f32 M=8 K=4096 N=4096"] = check_w8a16(8, 4096, 4096, torch.float32)
    heads = {f"{kind} M={M}": check_head(M, 4096, 128256, kind)
             for kind in ("bf16", "int8", "tied") for M in (4, 8)}
    for kind in ("bf16", "int8"):
        heads[f"qwen2-7b {kind} M=4"] = check_head(4, 3584, 152064, kind)
    keep = ("max_abs_err", "mismatch_share", "ms", "ms_cold", "ms_host",
            "ms_graph", "bound_ms", "bound_by", "plain_ms", "library_ms",
            "library_bf16_ms")
    log("phase2 weight gemms " + json.dumps({
        "w8a16_matmul": {k: {f: r.get(f) for f in keep}
                         for k, r in w8.items()},
        "head_matmul": {k: {f: r.get(f) for f in keep}
                        for k, r in heads.items()}}))
    torch.cuda.empty_cache()
    return w8["M=4 K=4096 N=14336"], heads["bf16 M=4"]


# row 14's two routes on the bf16 head: decode (4, 8, 16), the first row
# above head_plan's SIMT rows (9), the first above the decode routes' (17),
# the speculative verify (8 x 5 = 40),
# phase 6's pack (192), a prefill batch (2048) and the scorer (8192); the
# cold-L2 readings at decode and the verify
HEAD_ROUTE_ROWS = (4, 8, 9, 16, 17, 40, 192, 2048, 8192)
HEAD_COLD_ROWS = (4, 40)


def check_head_routes(M, kind, K=4096, V=128256, seed=0):
    """The bf16 head ("bf16": [K, V] row-major; "tied": embed.T of a
    row-major [V, K]) at x32 [M, K] on both of head_matmul's routes, each
    called on its own (weight_gemm._launch_head on head_route's plan):
    "simt" (f32 FMAs) and "wgmma" (the tensor cores on x32's three bf16
    terms, the split kernel's launch included), each against the plain
    version within HEAD_TOL with two planted faults — x32 rounded to bf16
    (the hi term alone) and the head's K rows 64..127 dropped. Device ms
    of each route (median of 25; above 192 rows of 3, after one warm
    call); on the route head_plan takes, up to 192 rows (a graph of 20
    calls of a 2048-row call would take seconds a rep), ms_host and
    ms_graph, and ms_cold at HEAD_COLD_ROWS;
    the plain version's and the library call's ms (the head's f32 copy and
    torch.matmul, which the plain version also runs). Bounds: bound_ms the
    tensor cores' least time for the exact f32 x bf16 products, max(bytes /
    3.35 TB/s, 3 x 2MKV / 989 TFLOP/s), and bound_f32_ms the f32 FMAs',
    max(bytes / 3.35 TB/s, 2MKV / 67 TFLOP/s); `route`: head_plan's."""
    import torch

    from localai_tpu_torch.ops.kernels import head_matmul_plain
    from localai_tpu_torch.ops.kernels import weight_gemm as wg

    g = torch.Generator(device="cuda").manual_seed(seed + M + K + V)
    x32 = torch.randn(M, K, device="cuda", generator=g)
    e = (torch.randn(V, K, device="cuda", generator=g)
         * K ** -0.5).to(torch.bfloat16)
    w = e.T if kind == "tied" else e.T.contiguous()
    del e
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    big = M > 192
    reps = dict(reps=3, warm=1) if big else {}
    ref = head_matmul_plain(x32, w)
    wd = w.clone()
    wd[64:128] = 0
    faults = {"x32_rounded_to_bf16": head_matmul_plain(
        x32.to(torch.bfloat16).float(), w),
        "k_tile_dropped": head_matmul_plain(x32, wd)}
    del wd
    res = {"route": wg.head_plan(M, V, K, sms)[0]}
    out = torch.empty(M, V, device="cuda")
    for route in ("simt", "wgmma"):
        plan = wg.head_route(route, M, V, K, sms)

        def fn(plan=plan):
            wg._launch_head("head_matmul", x32, w, out, kind == "tied",
                            plan)

        out.fill_(float("nan"))
        fn()
        torch.cuda.synchronize()
        r = _check_close(f"head_matmul {kind} {route} M={M}", out, ref,
                         HEAD_TOL, fault=faults)
        r["ms"] = _time_ms(fn, **reps)
        if route == res["route"] and not big:
            r["ms_host"] = _time_ms(fn, spin=False)
            r["ms_graph"] = _graph_ms(fn)
            if M in HEAD_COLD_ROWS:
                r["ms_cold"] = _time_ms(fn, cold=True)
        res[route] = r
    del faults, out, ref
    res["plain_ms"] = _time_ms(lambda: head_matmul_plain(x32, w), **reps)
    res["library_ms"] = _time_ms(lambda: x32 @ w.float(), **reps)
    flops, nbytes = 2.0 * M * K * V, 2 * K * V + 4 * M * K + 4 * M * V
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_tc = 3 * flops / PEAK_BF16 * 1e3
    res.update(bound_ms=max(t_bytes, t_tc),
               bound_by="operations" if t_tc >= t_bytes else "bytes",
               bound_f32_ms=max(t_bytes, flops / PEAK_F32 * 1e3),
               bound_formula=(f"max({nbytes:.4g} B / 3.35 TB/s, 3 x "
                              f"{flops:.4g} flop / 989 TFLOP/s); f32: "
                              f"{flops:.4g} flop / 67 TFLOP/s"))
    log(f"head_matmul {kind} routes M={M} K={K} V={V} " + json.dumps(res))
    torch.cuda.empty_cache()
    return res


def head_routes():
    """Row 14's two routes at HEAD_ROUTE_ROWS, bf16 and tied (line `phase2
    head routes`, with the least M at which the tensor-core route is the
    faster, a kind). Returns the rows."""
    rows = {f"{kind} M={M}": check_head_routes(M, kind)
            for kind in ("bf16", "tied") for M in HEAD_ROUTE_ROWS}
    keep = ("max_abs_err", "x32_rounded_to_bf16_err", "k_tile_dropped_err",
            "ms", "ms_cold", "ms_host", "ms_graph")
    faster = {kind: next((M for M in HEAD_ROUTE_ROWS
                          if rows[f"{kind} M={M}"]["wgmma"]["ms"]
                          < rows[f"{kind} M={M}"]["simt"]["ms"]), None)
              for kind in ("bf16", "tied")}
    log("phase2 head routes " + json.dumps({
        "rows": {k: {"route": r["route"], "plain_ms": r["plain_ms"],
                     "library_ms": r["library_ms"],
                     "bound_ms": r["bound_ms"],
                     "bound_f32_ms": r["bound_f32_ms"],
                     **{rt: {f: r[rt].get(f) for f in keep}
                        for rt in ("simt", "wgmma")}}
                 for k, r in rows.items()},
        "tensor_cores_faster_from_M": faster}))
    return rows


def head_lo_term_case(M, K, V, kind, seed=0):
    """Inputs on which x32's lo terms carry the whole product: along K, x
    alternates 1 + 2^-8 + 2^-16 (terms 1, 2^-8, 2^-16) and 1 + 2^-8 (lo
    0), row m scaled by 2^(m % 4), and column v of the head is +s_v, -s_v,
    +s_v, ... (s_v a random sign), so hi and mid cancel pair by pair and
    logit (m, v) is s_v * 2^(m % 4) * (K / 2) * 2^-16 exactly. Any
    partial sum of the terms' products over 64 K rows from an even start
    is a multiple of 2^(m%4 - 16) below 2^(m%4 + 7), exact in f32, so a
    route that sums the exact products in f32 64 K rows at a time gets
    every logit exactly. Returns x32 [M, K]
    f32, the head as head_matmul takes it ([K, V] bf16; "tied": embed.T
    of a row-major [V, K]) and the exact logits [M, V] f64, on the
    card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed + M + K + V)
    k = torch.arange(K, device="cuda")
    x = torch.where(k % 2 == 0, 1 + 2.0 ** -8 + 2.0 ** -16, 1 + 2.0 ** -8)
    scale = 2.0 ** (torch.arange(M, device="cuda") % 4)
    x32 = (scale[:, None] * x[None, :]).float()
    sign = torch.randint(0, 2, (V,), device="cuda", generator=g) * 2 - 1
    e = (sign[:, None] * (1 - 2 * (k % 2))[None, :]).to(torch.bfloat16)
    w = e.T if kind == "tied" else e.T.contiguous()
    exact = (scale[:, None].double() * (K // 2) * 2.0 ** -16
             * sign[None, :].double())
    return x32, w, exact


def check_head_lo_term(kind, M=40, K=4096, V=128256):
    """head_matmul (head_plan's tensor-core route at M = 40) on
    head_lo_term_case's inputs, against the exact logits within HEAD_TOL:
    a route that dropped x's lo term would return 0 for every logit
    (planted fault lo_term_dropped: the f64 product of hi + mid, from the
    plain split), and one that rounded x to bf16 2^(m%4) * K / 2 * 2^-7
    (x32_rounded_to_bf16). `exact`: the kernel's logits equal the exact
    ones bit for bit."""
    import torch

    from localai_tpu_torch.ops.kernels import head_matmul, launch_counts, \
        split_bf16_terms_plain
    from localai_tpu_torch.ops.kernels import weight_gemm as wg

    x32, w, exact = head_lo_term_case(M, K, V, kind)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    route = wg.head_plan(M, V, K, sms)[0]
    if route != "wgmma":
        raise AssertionError(f"phase2 head lo term: head_plan takes {route} "
                             f"at M = {M}")
    before = launch_counts()["split_bf16_terms"]
    out = head_matmul(x32, w)
    torch.cuda.synchronize()
    if launch_counts()["split_bf16_terms"] - before != 1:
        raise AssertionError("phase2 head lo term: no split launch")
    xs = split_bf16_terms_plain(x32)
    wd = w.double()
    faults = {"lo_term_dropped": (xs[0].double() + xs[1].double()) @ wd,
              "x32_rounded_to_bf16": x32.to(torch.bfloat16).double() @ wd}
    res = _check_close(f"head_matmul {kind} lo term M={M}", out, exact,
                       HEAD_TOL, fault=faults)
    res.update(route=route, exact=bool(torch.equal(out.double(), exact)))
    log(f"phase2 head lo term {kind} M={M} K={K} V={V} " + json.dumps(res))
    del x32, w, exact, out, xs, wd, faults
    torch.cuda.empty_cache()
    return res


def check_split(M=8192, K=4096, seed=0):
    """split_bf16_terms (the head's split kernel) at the scorer's x32 [M,
    K] (random values, the first row special ones: +-0, +-inf, NaN, f32's
    largest and least normal values, subnormals on bf16's grid of 2^-133,
    1e+-30) against its plain
    version on the card, BIT FOR BIT; the terms' f64 sum equals x32 on the
    finite values. Planted fault: hi rounded to nearest (x32.to(bf16)) in
    place of the cut, which the bit check must reject. Timings as _timings
    takes them; no PyTorch call splits f32 into bf16 terms (library
    null); bound: 4 bytes read and 6 written a value."""
    import torch

    from localai_tpu_torch.ops.kernels import split_bf16_terms, \
        split_bf16_terms_plain

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(M, K, device="cuda", generator=g) * 3
    special = torch.tensor(
        [0.0, -0.0, float("inf"), float("-inf"), float("nan"),
         3.4028234663852886e38, -3.4028234663852886e38, 2.0 ** -126,
         2.0 ** -133, -3 * 2.0 ** -133, 1e-30, -1e30, 1.0, 2.0 ** -110],
        device="cuda")
    x[0, :special.numel()] = special
    out = split_bf16_terms(x)
    torch.cuda.synchronize()
    ref = split_bf16_terms_plain(x)
    bits = out.view(torch.int16)
    if not torch.equal(bits, ref.view(torch.int16)):
        raise AssertionError("split_bf16_terms: the kernel's terms differ "
                             "from the plain version's at "
                             f"{int((bits != ref.view(torch.int16)).sum())}"
                             " places")
    fin = torch.isfinite(x)
    if not torch.equal(out.double().sum(0)[fin], x.double()[fin]):
        raise AssertionError("split_bf16_terms: hi + mid + lo != x32")
    bad = ref.clone()
    bad[0] = x.to(torch.bfloat16)
    fault = int((bad.view(torch.int16) != bits).sum())
    if not fault:
        raise AssertionError("split_bf16_terms: the bit check does not see "
                             "hi rounded to nearest")
    res = {"max_abs_err": 0.0, "tol": "bit for bit",
           "hi_rounded_to_nearest_differing": fault}
    del bad, ref, out
    nbytes = 10.0 * M * K
    res.update(ms=_time_ms(lambda: split_bf16_terms(x)),
               ms_host=_time_ms(lambda: split_bf16_terms(x), spin=False),
               ms_graph=_graph_ms(lambda: split_bf16_terms(x)),
               ms_cold=_time_ms(lambda: split_bf16_terms(x), cold=True),
               plain_ms=_time_ms(lambda: split_bf16_terms_plain(x)),
               library_ms=None, library_ms_host=None,
               bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
               bound_formula=f"{nbytes:.4g} B / 3.35 TB/s")
    log(f"phase2 split terms M={M} K={K} " + json.dumps(res))
    torch.cuda.empty_cache()
    return res


# Row 15, the expert GEMM, at Mixtral-8x7B's experts (E = 8): w1/w3 (K, N)
# = (4096, 14336) on x shared by the experts, w2 (14336, 4096) on one x
# slice an expert; M: decode, phase 12's ragged pack, a prefill batch.
# Kernel and plain version round the same bf16 weights' f32 sums once: one
# bf16 step an output, on at most 1% of them.
MOE_EXPERTS = 8
MOE_GEOMETRIES = [(4096, 14336, True), (14336, 4096, False)]
MOE_TOL = (1e-3, 2 ** -7)


def check_moe(M, K, N, shared, timed=True, cold=True, seed=0):
    """moe_w8_matmul at x [M, K] (shared) or [M, E, K] against an int8
    stack [E, K, N] with scales [E, 1, N]. Planted faults: expert e read
    with expert e + 1's scales, the K rows 64..127 of every expert
    dropped. library_ms: the reference's two calls, dequantize and
    torch.einsum (what the plain version runs too)."""
    import torch

    from localai_tpu_torch.ops.kernels import moe_w8_matmul, \
        moe_w8_matmul_plain
    from localai_tpu_torch.ops.quant import dequantize

    E = MOE_EXPERTS
    g = torch.Generator(device="cuda").manual_seed(seed + M + K + N)
    w = torch.randn(E, K, N, device="cuda", generator=g) * K ** -0.5
    s = torch.clamp_min(w.abs().amax(1, keepdim=True), 1e-8) / 127
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    del w
    x = torch.randn((M, K) if shared else (M, E, K), device="cuda",
                    generator=g).to(torch.bfloat16)
    eq = "mk,ekn->men" if shared else "mek,ekn->men"
    fn = lambda: moe_w8_matmul(x, q, s)  # noqa: E731
    plain = lambda: moe_w8_matmul_plain(x, q, s)  # noqa: E731
    out = fn()
    torch.cuda.synchronize()
    ref = plain()
    faults = None
    if timed:
        qd = q.clone()
        qd[:, 64:128] = 0
        faults = {"next_experts_scales": moe_w8_matmul_plain(
            x, q, torch.roll(s, -1, dims=0)),
            "k_tile_dropped": moe_w8_matmul_plain(x, qd, s)}
        del qd
    name = (f"moe_w8_matmul M={M} E={E} K={K} N={N} "
            f"{'shared' if shared else 'per-expert'} x")
    res = _check_close(name, out, ref, MOE_TOL, fault=faults,
                       share=W8_SHARE)
    if timed:
        xb = x.numel() * 2
        res.update(_timings(
            fn, plain, lambda: torch.einsum(
                eq, x, dequantize({"q": q, "s": s}, torch.bfloat16)),
            nbytes=E * K * N + 4 * E * N + xb + 2 * M * E * N,
            flops=2.0 * M * E * K * N, peak=PEAK_BF16, cold=cold))
    log(name + " " + json.dumps(res))
    del q, s, x, out, ref, faults
    torch.cuda.empty_cache()
    return res


def moe_gemms():
    """Row 15 of PERF.md §6: moe_w8_matmul against its plain version at
    Mixtral-8x7B's expert geometries for M = 4, 192 and 2048 (line
    `phase2 moe gemms`). Returns the main row: M = 4 on w1/w3."""
    rows = {f"M={M} K={K} N={N}": check_moe(M, K, N, shared,
                                            cold=M == W8_ROWS[0])
            for K, N, shared in MOE_GEOMETRIES for M in W8_ROWS}
    keep = ("max_abs_err", "mismatch_share", "next_experts_scales_err",
            "k_tile_dropped_err", "ms", "ms_cold", "ms_host", "ms_graph",
            "bound_ms", "bound_by", "plain_ms", "library_ms",
            "library_ms_cold")
    log("phase2 moe gemms " + json.dumps(
        {k: {f: r.get(f) for f in keep} for k, r in rows.items()}))
    return rows[f"M={W8_ROWS[0]} K=4096 N=14336"]


# Rows 13i4-15i4, the int4 twins of rows 13-15 (packed int4 weights,
# ops/kernels pack_int4): w4a16_matmul at the 8B's projections and Qwen2-
# 7B's wk/wv (3584, 512), the int4 head at the 8B's (4096, 128256) and
# moe_w4_matmul at Mixtral-8x7B's experts. Kernel and plain version
# compute the int8 rows' functions on the unpacked values, so they keep
# the int8 rows' tolerances. Planted faults on every row: the nibbles of
# a byte swapped (K rows 2j and 2j + 1 exchanged) and read unsigned; the
# experts also expert e read with expert e + 1's scales.
W4_GEOMETRIES = W8_GEOMETRIES + [(3584, 512)]
W4_HEAD_ROWS = (4, 192)
# moe_w4_matmul's rows: the decode route's (a batch of 1 to 16 streams),
# phase 12's ragged pack and a prefill batch
MOE4_ROWS = (1, 4, 8, 16, 192, 2048)
# the rows up to which the weight GEMMs take their decode routes
GEMV_ROWS = 16


def _int4_weight(K, N, g, E=None):
    """An N(0, 1/K) weight [K, N] (a stack [E, K, N]) on the card,
    quantized to packed int4 (QuantWeight: q uint8 [.., K/2, N])."""
    import torch

    from localai_tpu_torch.ops.quant import quantize

    shape = (K, N) if E is None else (E, K, N)
    return quantize(torch.randn(shape, device="cuda", generator=g)
                    * K ** -0.5, bits=4)


def _int4_faults(q):
    """{label: the int8 weight a misreading of packed q gives}: the nibbles
    of each byte swapped, and read as unsigned values."""
    import torch

    from localai_tpu_torch.ops.kernels import unpack_int4

    lo, hi = (q & 15).to(torch.int8), (q >> 4).to(torch.int8)
    unsigned = torch.stack([lo, hi], dim=-2).reshape(
        *q.shape[:-2], 2 * q.shape[-2], q.shape[-1])
    return {"nibbles_swapped": unpack_int4(((q & 15) << 4) | (q >> 4)),
            "nibbles_unsigned": unsigned}


def check_w4a16(M, K, N, cold=False, seed=0):
    """w4a16_matmul (bf16 x) at x [M, K] @ packed int4 [K/2, N] against
    its plain version, with the int4 faults planted. library_ms: the
    reference's calls on the card, the weight unpacked, cast and
    torch.matmul."""
    import torch

    from localai_tpu_torch.ops.kernels import unpack_int4, w4a16_matmul, \
        w4a16_matmul_plain, w8a16_matmul_plain

    g = torch.Generator(device="cuda").manual_seed(seed + M + K + N)
    qw = _int4_weight(K, N, g)
    q, s = qw.q, qw.s
    x = torch.randn(M, K, device="cuda", generator=g).to(torch.bfloat16)
    fn = lambda: w4a16_matmul(x, q, s)  # noqa: E731
    plain = lambda: w4a16_matmul_plain(x, q, s)  # noqa: E731
    out = fn()
    torch.cuda.synchronize()
    faults = {k: w8a16_matmul_plain(x, w, s)
              for k, w in _int4_faults(q).items()}
    name = f"w4a16_matmul bfloat16 M={M} K={K} N={N}"
    res = _check_close(name, out, plain(), W8_TOL["bfloat16"], fault=faults,
                       share=W8_SHARE)
    res.update(_timings(
        fn, plain, lambda: torch.matmul(x, unpack_int4(q).to(x.dtype)),
        nbytes=K * N // 2 + 2 * M * K + 2 * M * N + 4 * N,
        flops=2.0 * M * K * N, peak=PEAK_BF16, cold=cold))
    if cold:
        # the served condition: a graph streaming a new weight each call
        copies = {}
        res["ms_graph_cold"] = _graph_cold_ms(
            lambda i: (lambda w=copies.setdefault(i, q.clone()):
                       w4a16_matmul(x, w, s)), K * N // 2)
        del copies
    log(name + " " + json.dumps(res))
    return res


def check_head4(M, K, V, cold=False, seed=0):
    """head_matmul on a packed int4 head [K/2, V] (x32 f32 [M, K] rounded
    to bf16, f32 sums, then * s in f32) against its plain version, with
    the int4 faults planted. library_ms: the head unpacked, in f32, and
    torch.matmul."""
    import torch

    from localai_tpu_torch.ops.kernels import head_matmul, \
        head_matmul_plain, unpack_int4

    g = torch.Generator(device="cuda").manual_seed(seed + M + K + V)
    x32 = torch.randn(M, K, device="cuda", generator=g)
    qw = _int4_weight(K, V, g)
    q, s = qw.q, qw.s
    fn = lambda: head_matmul(x32, q, s)  # noqa: E731
    plain = lambda: head_matmul_plain(x32, q, s)  # noqa: E731
    out = fn()
    torch.cuda.synchronize()
    faults = {k: head_matmul_plain(x32, w, s)
              for k, w in _int4_faults(q).items()}
    name = f"head_matmul int4 M={M} K={K} V={V}"
    res = _check_close(name, out, plain(), HEAD_TOL, fault=faults)
    res.update(_timings(
        fn, plain, lambda: x32 @ unpack_int4(q).float(),
        nbytes=K * V // 2 + 4 * V + 4 * M * K + 4 * M * V,
        flops=2.0 * M * K * V, peak=PEAK_BF16, cold=cold))
    log(name + " " + json.dumps(res))
    del faults
    return res


def check_moe4(M, K, N, shared, cold=False, seed=0):
    """moe_w4_matmul at x [M, K] (shared) or [M, E, K] against a packed
    int4 stack [E, K/2, N] with scales [E, 1, N], with the int4 faults and
    expert e read with expert e + 1's scales planted, and at decode one
    unit of expert 1 dropped. library_ms: the reference's calls,
    dequantize (unpacking) and torch.einsum."""
    import torch

    from localai_tpu_torch.ops.kernels import moe_w4_matmul, \
        moe_w4_matmul_plain, moe_w8_matmul_plain
    from localai_tpu_torch.ops.quant import dequantize

    E = MOE_EXPERTS
    g = torch.Generator(device="cuda").manual_seed(seed + M + K + N)
    qw = _int4_weight(K, N, g, E=E)
    q, s = qw.q, qw.s
    x = torch.randn((M, K) if shared else (M, E, K), device="cuda",
                    generator=g).to(torch.bfloat16)
    eq = "mk,ekn->men" if shared else "mek,ekn->men"
    fn = lambda: moe_w4_matmul(x, q, s)  # noqa: E731
    plain = lambda: moe_w4_matmul_plain(x, q, s)  # noqa: E731
    out = fn()
    torch.cuda.synchronize()
    faults = {k: moe_w8_matmul_plain(x, w, s)
              for k, w in _int4_faults(q).items()}
    faults["next_experts_scales"] = moe_w4_matmul_plain(
        x, q, torch.roll(s, -1, dims=0))
    if M <= GEMV_ROWS:
        # the decode route's persistent grid: one unit (MOE4_BK K rows) of
        # expert 1 dropped, as a lost part of a cut tile would
        from localai_tpu_torch.ops.kernels import unpack_int4
        from localai_tpu_torch.ops.kernels.weight_gemm import MOE4_BK

        qd = unpack_int4(q)
        qd[1, MOE4_BK:2 * MOE4_BK] = 0
        faults["unit_dropped"] = moe_w8_matmul_plain(x, qd, s)
        del qd
    name = (f"moe_w4_matmul M={M} E={E} K={K} N={N} "
            f"{'shared' if shared else 'per-expert'} x")
    res = _check_close(name, out, plain(), MOE_TOL, fault=faults,
                       share=W8_SHARE)
    del faults
    res.update(_timings(
        fn, plain, lambda: torch.einsum(
            eq, x, dequantize({"q": q, "s": s}, torch.bfloat16)),
        nbytes=E * K * N // 2 + 4 * E * N + x.numel() * 2 + 2 * M * E * N,
        flops=2.0 * M * E * K * N, peak=PEAK_BF16, cold=cold))
    log(name + " " + json.dumps(res))
    del q, s, x, out
    torch.cuda.empty_cache()
    return res


def int4_gemms():
    """Rows 13i4, 14i4 and 15i4 of PERF.md §6 (line `phase2 int4 gemms`):
    w4a16_matmul at the 8B's four projection shapes and Qwen2-7B's wk/wv
    for M = 4, 192 and 2048, the int4 head at M = 4 and 192, and
    moe_w4_matmul at Mixtral-8x7B's experts for MOE4_ROWS, each
    against its plain version with its planted faults; cold L2 readings
    at M = 4. Returns the main rows: w_gate, the head and w1/w3 at M =
    4."""
    import torch

    w4 = {f"M={M} K={K} N={N}": check_w4a16(M, K, N, cold=M == 4)
          for K, N in W4_GEOMETRIES for M in W8_ROWS}
    heads = {f"M={M}": check_head4(M, 4096, 128256, cold=M == 4)
             for M in W4_HEAD_ROWS}
    moe = {f"M={M} K={K} N={N}": check_moe4(M, K, N, shared, cold=M == 4)
           for K, N, shared in MOE_GEOMETRIES for M in MOE4_ROWS}
    keep = ("max_abs_err", "mismatch_share", "nibbles_swapped_err",
            "nibbles_unsigned_err", "next_experts_scales_err",
            "unit_dropped_err", "ms",
            "ms_cold", "ms_host", "ms_graph", "ms_graph_cold", "bound_ms",
            "bound_by", "plain_ms", "library_ms", "library_ms_cold")
    log("phase2 int4 gemms " + json.dumps({
        "w4a16_matmul": {k: {f: r.get(f) for f in keep}
                         for k, r in w4.items()},
        "head_matmul_int4": {k: {f: r.get(f) for f in keep}
                             for k, r in heads.items()},
        "moe_w4_matmul": {k: {f: r.get(f) for f in keep}
                          for k, r in moe.items()}}))
    torch.cuda.empty_cache()
    return (w4["M=4 K=4096 N=14336"], heads["M=4"],
            dict(moe["M=4 K=4096 N=14336"],
                 w2=moe["M=4 K=14336 N=4096"]))


# the speculative leg's shapes (phase 8): the Llama-3.2-1B draft decodes
# at H=32, KVH=8, D=64 over eight 4096-token slots, through its
# projections (K, N) and its tied head; the 8B target verifies eight
# (gamma+1)-row windows (M = 8 x 5 through its projections; in a ragged
# pack, one window of 5 rows in each 8-row block, beside phase 6's chunk)
W8_GEOMETRIES_1B = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]
SPEC_GAMMA = 4
SPEC_KV = [33, 49, 332, 732, 1532, 672, 712, 4095]


def spec_shapes():
    """Rows 2, 8-11, 13 and 14 at the speculative leg's shapes, each with
    its planted fault (the checks' own). Returns the draft's decode row
    (row 2 at D = 64)."""
    import torch

    bf16, G = torch.bfloat16, SPEC_GAMMA
    res = {"ragged_decode 1B draft D=64": check_decode(
        8, 32, 8, 4096, 64, bf16, SPEC_KV)}
    for K, N in W8_GEOMETRIES_1B:
        res[f"w8a16_matmul 1B draft M=8 K={K} N={N}"] = check_w8a16(
            8, K, N, bf16, cold=False)
    res["head_matmul 1B tied M=8"] = check_head(8, 2048, 128256, "tied",
                                                cold=False)
    M = 8 * (G + 1)
    for K, N in W8_GEOMETRIES:
        res[f"w8a16_matmul 8B verify M={M} K={K} N={N}"] = check_w8a16(
            M, K, N, bf16, cold=False)
    res[f"head_matmul 8B verify bf16 M={M}"] = check_head(
        M, 4096, 128256, "bf16", cold=False)
    seqs = [(n, G + 1) for n in SPEC_KV] + [
        (RAGGED_CHUNK[0] + RAGGED_CHUNK[1], RAGGED_CHUNK[1])]
    for q8, sfx in ((False, ""), (True, "_q8")):
        res["ragged_paged_attention" + sfx + " spec pack"] = \
            check_ragged_attention(32, 8, 128, bf16, None, None, 32, q8=q8,
                                   nb=129, seqs=seqs)
        res["ragged_scatter_append" + sfx + " spec pack"] = \
            check_ragged_scatter(8, 128, bf16, None, None, 32, q8=q8,
                                 nb=129, seqs=seqs)
    keep = ("max_abs_err", "planted_fault_err", "mismatch_share", "ms",
            "ms_graph", "bound_ms", "bound_by", "plain_ms", "library_ms")
    log("phase2 spec shapes " + json.dumps(
        {k: {f: r.get(f) for f in keep} for k, r in res.items()}))
    torch.cuda.empty_cache()
    return res["ragged_decode 1B draft D=64"]


def phase_kernels():
    """Each kernel against its plain version at the main path's shapes
    (plus small f32 / GQA / window cases for the algorithm)."""
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    H, KVH, D = 32, 8, 128
    main = {}
    # main-path shapes: 4 slots, 512-token prefill bucket, 2048 context;
    # the 64-token bucket that phase 4's prompts of 1 and 17 tokens take
    main["flash_prefill"] = check_prefill(4, 512, H, KVH, D, bf16,
                                          [512, 300, 17, 1], cold=True)
    check_prefill(2, 64, H, KVH, D, bf16, [17, 1])
    check_prefill(2, 256, H, KVH, D, bf16, [256, 200], window=64,
                  timed=False)
    check_prefill(3, 64, 8, 1, 64, f32, [64, 40, 1], timed=False)
    check_prefill(2, 96, 4, 4, 128, f32, [96, 50], window=16, timed=False)
    lens4 = [1, 129, 1000, 2048]
    lens16 = lens4 + [7, 64, 255, 256, 511, 700, 1024, 1500, 1777, 2000,
                      2047, 300]
    main["ragged_decode"] = check_decode(4, H, KVH, 2048, D, bf16, lens4,
                                         cold=True)
    check_decode(16, H, KVH, 2048, D, bf16, lens16)
    check_decode(3, 8, 2, 256, 64, f32, [5, 200, 256], timed=False)
    check_decode(2, H, KVH, 2048, D, bf16, [1500, 40], window=256,
                 timed=False)
    main["ragged_decode_q8"] = check_decode(4, H, KVH, 2048, D, bf16, lens4,
                                            q8=True, cold=True)
    check_decode(16, H, KVH, 2048, D, bf16, lens16, q8=True)
    check_decode(3, 8, 1, 256, 64, f32, [5, 200, 256], q8=True,
                 timed=False)
    check_decode(2, H, KVH, 2048, D, bf16, [1500, 40], q8=True, window=256,
                 timed=False)
    # paged (kernels 3, 5, 6, 7) over a shuffled pool. Main: phase 5's
    # shapes — 8 slots, a 4096-token table (MAXB 32) over the 129-block
    # pool, lengths of its requests mid-decode (prompts 1, 17, 300, 700,
    # 1500, 640 and 680 plus 32 generated) and one slot at the context end;
    # extra: B=4 and B=16 at MAXB 16 (PR 1's dense shapes)
    lens8 = [33, 49, 332, 732, 1532, 672, 712, 4095]
    main["ragged_decode_paged"] = check_paged_decode(8, H, KVH, D, bf16,
                                                     lens8, 32, nb=129,
                                                     cold=True)
    check_paged_decode(4, H, KVH, D, bf16, lens4, 16)
    check_paged_decode(16, H, KVH, D, bf16, lens16, 16)
    check_paged_decode(3, 8, 2, 64, f32, [5, 200, 256], 2, timed=False)
    check_paged_decode(2, H, KVH, D, bf16, [1500, 40], 16, window=256,
                       timed=False)
    main["ragged_decode_q8_paged"] = check_paged_decode(
        8, H, KVH, D, bf16, lens8, 32, q8=True, nb=129, cold=True)
    check_paged_decode(4, H, KVH, D, bf16, lens4, 16, q8=True)
    check_paged_decode(16, H, KVH, D, bf16, lens16, 16, q8=True)
    check_paged_decode(3, 8, 1, 64, f32, [5, 200, 256], 2, q8=True,
                       timed=False)
    check_paged_decode(2, H, KVH, D, bf16, [1500, 40], 16, q8=True,
                       window=256, timed=False)
    main["paged_scatter_append"] = check_paged_scatter(8, KVH, D, bf16)
    check_paged_scatter(16, KVH, D, bf16)
    check_paged_scatter(5, 2, 64, f32, nb=12, maxb=4)
    main["paged_scatter_append_q8"] = check_paged_scatter(8, KVH, D, bf16,
                                                          q8=True)
    check_paged_scatter(16, KVH, D, bf16, q8=True)
    check_paged_scatter(5, 2, 64, f32, q8=True, nb=12, maxb=4)
    # ragged (kernels 8-11) at phase 6's pack over the 129-block pool (MAXB
    # 32); extra: f32 at the same pack, a small sliding-window stream
    rd, rc = RAGGED_DECODE, RAGGED_CHUNK
    main["ragged_paged_attention"] = check_ragged_attention(
        H, KVH, D, bf16, rd, rc, 32, nb=129, cold=True)
    main["ragged_paged_attention_q8"] = check_ragged_attention(
        H, KVH, D, bf16, rd, rc, 32, q8=True, nb=129, cold=True)
    check_ragged_attention(H, KVH, D, f32, rd, rc, 32, nb=129)
    check_ragged_attention(8, 2, 64, f32, [5, 200, 300], (96, 40), 4,
                           window=64)
    check_ragged_attention(8, 2, 64, bf16, [5, 200, 300], (96, 40), 4,
                           q8=True, window=64)
    main["ragged_scatter_append"] = check_ragged_scatter(KVH, D, bf16, rd,
                                                         rc, 32, nb=129)
    main["ragged_scatter_append_q8"] = check_ragged_scatter(
        KVH, D, bf16, rd, rc, 32, q8=True, nb=129)
    check_ragged_scatter(2, 64, f32, [5, 200, 300], (96, 40), 4)
    # every GQA group size and head_dim up to 256, each with its planted
    # fault: rows 8/9 and 3/5 at Qwen2-7B's H=28, KVH=4 (G = 7) at the main
    # shapes; rows 2/4 at Llama-3.1-405B's G = 16 (H=128, KVH=8); row 1 at
    # head_dim 256 (Gemma-2-9B's H=16, KVH=8 in bf16; a small f32 case)
    wide = {
        "ragged_paged_attention H=28 KVH=4": check_ragged_attention(
            28, 4, D, bf16, rd, rc, 32, nb=129),
        "ragged_paged_attention_q8 H=28 KVH=4": check_ragged_attention(
            28, 4, D, bf16, rd, rc, 32, q8=True, nb=129),
        "ragged_decode_paged H=28 KVH=4": check_paged_decode(
            8, 28, 4, D, bf16, lens8, 32, nb=129),
        "ragged_decode_q8_paged H=28 KVH=4": check_paged_decode(
            8, 28, 4, D, bf16, lens8, 32, q8=True, nb=129),
        "ragged_decode H=128 KVH=8": check_decode(4, 128, 8, 2048, D, bf16,
                                                  lens4),
        "ragged_decode_q8 H=128 KVH=8": check_decode(
            4, 128, 8, 2048, D, bf16, lens4, q8=True),
        "flash_prefill H=16 KVH=8 D=256": check_prefill(
            4, 512, 16, 8, 256, bf16, [512, 300, 17, 1]),
        "flash_prefill f32 H=8 KVH=2 D=256": check_prefill(
            2, 96, 8, 2, 256, f32, [96, 50]),
    }
    ragged_packs(H, KVH, D)
    main.update(tier_kernels())
    main["w8a16_matmul"], main["head_matmul"] = weight_gemms()
    main["head_routes"] = head_routes()
    for kind in ("bf16", "tied"):
        check_head_lo_term(kind)
    main["split_bf16_terms"] = check_split()
    main["moe_w8_matmul"] = moe_gemms()
    (main["w4a16_matmul"], main["head_matmul_int4"],
     main["moe_w4_matmul"]) = int4_gemms()
    main["spec shapes"] = spec_shapes()
    main["launch floor"] = launch_floor()
    log("phase2 wide geometry " + json.dumps({
        k: {f: r.get(f) for f in ("max_abs_err", "planted_fault_err", "ms",
                                  "ms_host", "ms_graph", "bound_ms",
                                  "bound_by", "plain_ms", "library_ms")}
        for k, r in wide.items()}))
    log("phase2 kernels: all within tolerance")
    return main


# ------------------------------------------------- phase 2: the KV tier

# the tiered paged decode at the 8B's widths: 8 slots up to 32768 tokens,
# sinks 256, window 4096, the ring of the engine's default margin (256)
TIER_LENS = [32768, 30001, 24577, 16500, 8193, 4097, 2000, 300]
TIER_SINKS, TIER_WINDOW, TIER_MARGIN = 256, 4096, 256


def _tier_geometry(sinks, window):
    """(sink blocks, ring blocks) of sink_window(sinks, window) at the
    engine's default margin (engine/kvtier.py)."""
    from localai_tpu_torch.engine import kvtier

    pol = kvtier.parse_policy(f"sink_window(sinks={sinks}, window={window})")
    return pol.sink_blocks, kvtier.ring_blocks(window, TIER_MARGIN)


def _tier_rows(L, sb, rw, sinks, window, demoted):
    """(hot rows, cold rows, hot blocks, cold blocks) a tiered read of one
    slot of length L takes: the resident rows it keeps (sinks and window;
    with the cold tier every resident row not demoted) and the demoted rows
    of the cold pool (`demoted`: raw blocks in the cold table, None without
    the cold tier)."""
    cur = (L - 1) // 128
    ring_lo = max(sb, cur - rw + 1)
    hot = cold = hb = cb = 0
    for raw in range(cur + 1):
        rows = [p for p in range(raw * 128, min(raw * 128 + 128, L))]
        if demoted is not None and raw in demoted:
            cold += len(rows)
            cb += 1
            continue
        if raw >= sb and raw < ring_lo:
            continue
        kept = rows if demoted is not None else [
            p for p in rows if p >= L - window or p < sinks]
        hot += len(kept)
        hb += 1 if kept else 0
    return hot, cold, hb, cb


def check_tier_decode(dtype, q8=False, cold=False, lens=TIER_LENS,
                      H=32, KVH=8, D=128, sinks=TIER_SINKS,
                      window=TIER_WINDOW, timed=True, seed=0,
                      untiered=True):
    """The tiered paged decode (rows 3/5 with the KV tier) against its plain
    version: compact ring tables of sb + rw distinct blocks a slot of a
    shuffled pool; with `cold`, each slot's middle — raw blocks sb ..
    (L - window)/128 - 1, the ones the engine demotes — in an int8 cold
    pool through the cold table. Planted faults that the bar must reject:
    the ring map off by one column (the ring's table columns rotated), and
    (cold) the cold tier read without its scales. Timed: ms (warm and cold
    L2), ms_graph, the plain version, and the untiered paged kernel over
    the full lengths (a table of ceil(L/128) blocks, `untiered_ms`);
    bound_ms from the live bytes — the kept rows at the hot dtype, the
    demoted rows at int8 with their scales. untiered=False skips the
    untiered and plain timings (chip_tier_sweep.py, which sets
    flash_attention's span constants to time other plans)."""
    import torch

    from localai_tpu_torch.ops.kernels import (
        launch_counts, ragged_decode, ragged_decode_plain, ragged_decode_q8,
        ragged_decode_q8_plain, tier_plan,
    )
    from localai_tpu_torch.ops.kvcache import QuantKV, quantize_tokens

    B = len(lens)
    sb, rw = _tier_geometry(sinks, window)
    maxb = sb + rw
    nb = B * maxb + 1
    g = torch.Generator(device="cuda").manual_seed(seed)
    k = torch.randn(nb, KVH, 128, D, device="cuda", generator=g)
    v = torch.randn(nb, KVH, 128, D, device="cuda", generator=g)
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(
        seed)) + 1
    table = perm[:B * maxb].reshape(B, maxb).to(torch.int32).cuda()
    q = torch.randn(B, 1, H, D, device="cuda", generator=g).to(dtype)

    def full(x):
        return torch.full((B,), x, dtype=torch.int32, device="cuda")

    kvt = dict(sb=full(sb), rw=full(rw), sinks=full(sinks),
               window=full(window))
    if q8:
        kq, ks = quantize_tokens(k)
        vq, vs = quantize_tokens(v)
        pools = (kq, ks.reshape(nb, KVH, 1, 128), vq,
                 vs.reshape(nb, KVH, 1, 128))
        kernel, plain_fn = ragged_decode_q8, ragged_decode_q8_plain
    else:
        pools = (k.to(dtype), v.to(dtype))
        kernel, plain_fn = ragged_decode, ragged_decode_plain
    kw, demoted = {}, [None] * B
    mbc = -(-max(lens) // 128)
    if cold:
        ctab = torch.zeros(B, mbc, dtype=torch.int32)
        ci = 1
        demoted = [set() for _ in range(B)]
        for b, n in enumerate(lens):
            for raw in range(sb, max((n - window) // 128, sb)):
                ctab[b, raw] = ci
                demoted[b].add(raw)
                ci += 1
        kvt["cold_tab"] = ctab.cuda()
        ck = [quantize_tokens(torch.randn(ci, KVH, 128, D, device="cuda",
                                          generator=g)) for _ in range(2)]
        kw["cold_kv"] = tuple(QuantKV(a, s.reshape(ci, KVH, 1, 128))
                              for a, s in ck)
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    fn = lambda: kernel(q, *pools, lens_t, table=table,  # noqa: E731
                        kvt=kvt, **kw)
    plain = lambda: plain_fn(q, *pools, lens_t, table=table,  # noqa: E731
                             kvt=kvt, **kw)
    kname = ("ragged_decode_q8_paged_tier" if q8
             else "ragged_decode_paged_tier")
    before = launch_counts()[kname]
    out = fn()
    torch.cuda.synchronize()
    if launch_counts()[kname] != before + 1:
        raise AssertionError(f"{kname}: one call did not count one launch")
    ref = plain()
    shifted = table.clone()
    shifted[:, sb:] = table[:, sb:].roll(-1, dims=1)
    faults = {"planted_fault_ring_off_by_one": plain_fn(
        q, *pools, lens_t, table=shifted, kvt=kvt, **kw)}
    if cold:
        faults["planted_fault_cold_scales_dropped"] = plain_fn(
            q, *pools, lens_t, table=table, kvt=kvt,
            cold_kv=tuple(QuantKV(c.q, torch.ones_like(c.s))
                          for c in kw["cold_kv"]))
    name = (f"{kname}{' cold' if cold else ''} {str(dtype).split('.')[-1]} "
            f"B={B} H={H} KVH={KVH} D={D} MAXB={maxb} (sb {sb}, ring {rw}) "
            f"lengths={lens} sinks={sinks} window={window}")
    tol = TOL[str(dtype).split(".")[-1]]
    res = _check_close(name, out, ref, tol, fault=faults)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res["plan"] = tier_plan(maxb, mbc if cold else 0, B * KVH, sms, q8)
    if timed:
        es = q.element_size()
        kv_es = 1 if q8 else es
        hot = cold_rows = blocks = 0
        for b, n in enumerate(lens):
            h_, c_, hb, cb = _tier_rows(n, sb, rw, sinks, window,
                                        demoted[b])
            hot, cold_rows, blocks = hot + h_, cold_rows + c_, blocks + hb + cb
        # the kept rows' K/V (int8: with scales), the demoted rows' int8
        # K/V and scales, the table and cold-table entries read, q and out,
        # lengths and the geometry
        nbytes = (hot * KVH * 2 * (D * kv_es + (4 if q8 else 0))
                  + cold_rows * KVH * 2 * (D + 4) + 8 * blocks
                  + 2 * B * H * D * es + 4 * B * 5)
        flops = 4.0 * (hot + cold_rows) * H * D
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        res.update(ms=_time_ms(fn), ms_cold=_time_ms(fn, cold=True),
                   ms_host=_time_ms(fn, spin=False), ms_graph=_graph_ms(fn),
                   live_rows={"hot": hot, "cold": cold_rows,
                              "of": sum(lens)},
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   bound_formula=(f"max({nbytes:.4g} B of kept K/V + demoted "
                                  f"int8 K/V + tables + q/out / 3.35 TB/s, "
                                  f"{flops:.4g} flop / {peak / 1e12:.0f} "
                                  f"TFLOP/s)"),
                   library_ms=None, library_ms_host=None,
                   library_note="no PyTorch call attends through a ring")
    if timed and untiered:
        res["plain_ms"] = _time_ms(plain, reps=5, warm=1)
        # the untiered kernel over the full lengths (ceil(L/128) blocks a
        # slot of a pool holding them all)
        need = [-(-n // 128) for n in lens]
        nbf = sum(need) + 1
        kf = torch.randn(nbf, KVH, 128, D, device="cuda", generator=g)
        vf = torch.randn(nbf, KVH, 128, D, device="cuda", generator=g)
        ftab = torch.zeros(B, mbc, dtype=torch.int32)
        used = 1
        for b, a in enumerate(need):
            ftab[b, :a] = torch.arange(used, used + a)
            used += a
        ftab = ftab.cuda()
        if q8:
            fq, fs = quantize_tokens(kf)
            gq, gs = quantize_tokens(vf)
            fpools = (fq, fs.reshape(nbf, KVH, 1, 128), gq,
                      gs.reshape(nbf, KVH, 1, 128))
        else:
            fpools = (kf.to(dtype), vf.to(dtype))
        untiered = lambda: kernel(q, *fpools, lens_t,  # noqa: E731
                                  table=ftab)
        res.update(untiered_ms=_time_ms(untiered),
                   untiered_ms_cold=_time_ms(untiered, cold=True))
        del kf, vf, fpools
    log(name + " " + json.dumps(res))
    return res


def check_tier_sentinels(q8):
    """Full-policy sentinels (sb = the table width, rw = 1, sinks = window
    = the context) give the untiered paged kernel's output bit for bit, at
    phase 2's main paged shapes."""
    import torch

    from localai_tpu_torch.ops.kernels import ragged_decode, ragged_decode_q8
    from localai_tpu_torch.ops.kvcache import quantize_tokens

    lens8 = [33, 49, 332, 732, 1532, 672, 712, 4095]
    k, v, table, nb = _paged_pools(8, 8, 128, lens8, 32, nb=129)
    q = torch.randn(8, 1, 32, 128, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(
                        2)).to(torch.bfloat16)
    if q8:
        kq, ks = quantize_tokens(k)
        vq, vs = quantize_tokens(v)
        pools = (kq, ks.reshape(nb, 8, 1, 128), vq, vs.reshape(nb, 8, 1, 128))
        kernel = ragged_decode_q8
    else:
        pools = (k.to(torch.bfloat16), v.to(torch.bfloat16))
        kernel = ragged_decode
    lt = torch.tensor(lens8, dtype=torch.int32, device="cuda")

    def full(x):
        return torch.full((8,), x, dtype=torch.int32, device="cuda")

    kvt = dict(sb=full(32), rw=full(1), sinks=full(4096), window=full(4096))
    a = kernel(q, *pools, lt, table=table, kvt=kvt)
    b = kernel(q, *pools, lt, table=table)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"tiered decode (q8={q8}) with full-policy "
                             f"sentinels differs from the untiered kernel: "
                             f"{float((a.float() - b.float()).abs().max())}")
    return True


# phase 6's pack over ring tables of phase 10's policy (sinks 128, window
# 1024; sb 1 and a ring of 12: MAXB 13); sequence 0 (33 tokens) carries the
# full-policy sentinels
TIER_RAGGED = dict(sinks=128, window=1024)


def check_tier_ragged(H, KVH, D, dtype, q8=False, timed=True):
    """The tiered ragged attention (rows 8/9 with the KV tier) against its
    plain version at phase 6's pack (eight decode rows and a 128-row chunk
    at 1024) over compact ring tables; a planted ring map off by one column
    must fail. bound_ms from the keys each q tile keeps."""
    import torch

    from localai_tpu_torch.ops.kernels import (
        launch_counts, ragged_paged_attention, ragged_paged_attention_plain,
        ragged_paged_attention_q8, ragged_paged_attention_q8_plain,
        ragged_split,
    )
    from localai_tpu_torch.ops.kvcache import quantize_tokens

    sinks, window = TIER_RAGGED["sinks"], TIER_RAGGED["window"]
    sb, rw = _tier_geometry(sinks, window)
    maxb = sb + rw
    seqs = _ragged_seqs(RAGGED_DECODE, RAGGED_CHUNK)
    n = len(seqs)
    nb = n * maxb + 1
    g = torch.Generator(device="cuda").manual_seed(4)
    k = torch.randn(nb, KVH, 128, D, device="cuda", generator=g)
    v = torch.randn(nb, KVH, 128, D, device="cuda", generator=g)
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(
        4)) + 1
    tables = perm[:n * maxb].reshape(n, maxb).to(torch.int32).cuda()
    block_seq, qstart, live, row = [], [], [], 0
    for kvl, ql in seqs:
        qstart.append(row)
        block_seq += [len(qstart) - 1] * -(-ql // 8)
        live += list(range(row, row + ql))
        row += -(-ql // 8) * 8

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device="cuda")

    meta = dict(block_seq=i32(block_seq), qstart=i32(qstart),
                qlen=i32([x[1] for x in seqs]),
                kvlen=i32([x[0] for x in seqs]), tables=tables)
    kvt = dict(sb=i32([maxb] + [sb] * (n - 1)), rw=i32([1] + [rw] * (n - 1)),
               sinks=i32([8192] + [sinks] * (n - 1)),
               window=i32([8192] + [window] * (n - 1)))
    q = torch.randn(row, H, D, device="cuda", generator=g).to(dtype)
    if q8:
        kq, ks = quantize_tokens(k)
        vq, vs = quantize_tokens(v)
        pools = (kq, ks.reshape(nb, KVH, 1, 128), vq,
                 vs.reshape(nb, KVH, 1, 128))
        kernel = ragged_paged_attention_q8
        plain_fn = ragged_paged_attention_q8_plain
    else:
        pools = (k.to(dtype), v.to(dtype))
        kernel, plain_fn = ragged_paged_attention, ragged_paged_attention_plain
    fn = lambda: kernel(q, *pools, **meta, kvt=kvt)  # noqa: E731
    plain = lambda: plain_fn(q, *pools, **meta, kvt=kvt)  # noqa: E731
    kname = ("ragged_paged_attention_q8_tier" if q8
             else "ragged_paged_attention_tier")
    before = launch_counts()[kname]
    out = fn()
    torch.cuda.synchronize()
    if launch_counts()[kname] != before + 1:
        raise AssertionError(f"{kname}: one call did not count one launch")
    ref = plain()
    shifted = tables.clone()
    shifted[:, sb:] = tables[:, sb:].roll(-1, dims=1)
    fault = plain_fn(q, *pools, **dict(meta, tables=shifted), kvt=kvt)
    rows = torch.tensor(live, device="cuda")
    desc = ",".join(f"{a}/{b}" for a, b in seqs)
    name = (f"{kname} {str(dtype).split('.')[-1]} T={row} MAXB={maxb} "
            f"(sb {sb}, ring {rw}) NB={nb} H={H} KVH={KVH} D={D} "
            f"kvlen/qlen=[{desc}] sinks={sinks} window={window} (sequence 0 "
            f"full-policy)")
    tol = TOL[str(dtype).split(".")[-1]]
    res = _check_close(name, out[rows], ref[rows], tol,
                       fault={"planted_fault_ring_off_by_one": fault[rows]})
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res["nsplit"], res["split"] = ragged_split(row, maxb, KVH, sms)
    if timed:
        es = q.element_size()
        kv_es = 1 if q8 else es
        pairs = kv_read = entries = 0
        for s, (kvl, ql) in enumerate(seqs):
            snk, win = (8192, 8192) if s == 0 else (sinks, window)
            first = kvl - ql
            keys = set(range(min(snk, kvl))) | set(
                range(max(first - win + 1, 0), kvl))
            kv_read += len(keys)
            entries += len({p // 128 for p in keys})
            for p in range(first, kvl):
                pairs += min(p + 1, win) + max(0, min(snk, p - win + 1))
        nbytes = (kv_read * KVH * 2 * (D * kv_es + (4 if q8 else 0))
                  + 2 * len(live) * H * D * es + 4 * entries)
        flops = 4.0 * pairs * H * D
        peak = PEAK_F32 if dtype == torch.float32 else PEAK_BF16
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        res.update(ms=_time_ms(fn), ms_cold=_time_ms(fn, cold=True),
                   ms_host=_time_ms(fn, spin=False), ms_graph=_graph_ms(fn),
                   plain_ms=_time_ms(plain),
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   bound_formula=(f"max({nbytes:.4g} B of kept K/V + live "
                                  f"q/out + table / 3.35 TB/s, {flops:.4g} "
                                  f"flop / {peak / 1e12:.0f} TFLOP/s)"),
                   library_ms=None, library_ms_host=None,
                   library_note="no PyTorch call attends through a ring")
    log(name + " " + json.dumps(res))
    return res


def check_demote(dtype, layers=32, KVH=8, D=128, NBC=64):
    """The demotion (paged_demote_q8: row 7's quantizing kernel over one
    hot block's KVH*128 rows a layer) against its plain version, bit for
    bit over the whole cold pool, with a planted fault (the targets one
    row off) that must differ; ms a layer and a block (`layers` launches,
    as Engine._dev_demote runs them)."""
    import torch

    from localai_tpu_torch.ops.kernels import (
        demote_targets, paged_demote_q8, paged_demote_q8_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(8)
    hot = torch.randn(layers, 4, KVH, 128, D, device="cuda",
                      generator=g).to(dtype)
    cq = torch.zeros(layers, NBC, KVH, 128, D, dtype=torch.int8,
                     device="cuda")
    cs = torch.zeros(layers, NBC, KVH, 1, 128, device="cuda")
    pools = [cq, cs, cq.clone(), cs.clone()]
    plain_pools = [p.clone() for p in pools]
    rows = torch.arange(KVH * 128, dtype=torch.int32, device="cuda")
    targets = demote_targets(5, KVH, rows)

    def block(pl, fn, tg=targets):
        for i in range(layers):
            fn(pl[0][i], pl[1][i], pl[2][i], pl[3][i], hot[i, 2], hot[i, 3],
               tg)

    block(pools, paged_demote_q8)
    torch.cuda.synchronize()
    block(plain_pools, paged_demote_q8_plain)
    for a, b in zip(pools, plain_pools):
        if not torch.equal(a, b):
            raise AssertionError("paged_demote_q8 differs from its plain "
                                 "version")
    bad = [p.clone() for p in plain_pools]
    block(bad, paged_demote_q8_plain, (targets[0], (targets[1] + 1) % 128))
    if all(torch.equal(a, b) for a, b in zip(pools, bad)):
        raise AssertionError("the demote check does not reject the planted "
                             "fault")
    one = lambda: paged_demote_q8(cq[0], cs[0], cq[0], cs[0],  # noqa: E731
                                  hot[0, 2], hot[0, 3], targets)
    es = hot.element_size()
    nbytes = 2 * KVH * 128 * (D * es + D + 4)
    res = {"max_abs_err": 0.0, "tol": "bit-exact",
           "planted_fault": "targets one row off: differs",
           "ms": _time_ms(one), "ms_host": _time_ms(one, spin=False),
           "ms_graph": _graph_ms(one),
           "plain_ms": _time_ms(lambda: paged_demote_q8_plain(
               cq[0], cs[0], cq[0], cs[0], hot[0, 2], hot[0, 3], targets)),
           "ms_block": _time_ms(lambda: block(pools, paged_demote_q8)),
           "layers": layers,
           "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
           "bound_formula": f"{nbytes} B (a layer's K and V block read, "
                            f"int8 rows and scales written) / 3.35 TB/s",
           "library_ms": None, "library_ms_host": None,
           "library_note": "no single PyTorch call quantizes rows and "
                           "scatters them with their scales"}
    log(f"paged_demote_q8 {str(dtype).split('.')[-1]} KVH={KVH} D={D} "
        + json.dumps(res))
    return res


def tier_kernels():
    """Phase 2's KV-tier kernels: the tiered paged decode (bf16 and int8
    hot pools under the drop policy, the cold tier over a bf16 pool — the
    reference keeps the cold tier to dense hot pools — and small f32
    cases), the sentinels' bit-exactness, the tiered ragged attention at
    phase 6's pack (bf16, int8, f32), and the demote."""
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    t0 = time.perf_counter()
    out = {
        "ragged_decode_paged_tier": check_tier_decode(bf16),
        "ragged_decode_q8_paged_tier": check_tier_decode(bf16, q8=True),
        "ragged_decode_paged_tier cold": check_tier_decode(bf16, cold=True),
    }
    for cold in (False, True):
        check_tier_decode(f32, cold=cold, lens=[3000, 1100, 300, 1], H=8,
                          KVH=2, D=64, sinks=100, window=700, timed=False)
    check_tier_decode(f32, q8=True, lens=[3000, 1100, 300, 1], H=8, KVH=2,
                      D=64, sinks=100, window=700, timed=False)
    check_tier_decode(bf16, lens=TIER_LENS, H=28, KVH=4, timed=False)
    check_tier_decode(bf16, cold=True, lens=TIER_LENS, H=128, KVH=8,
                      timed=False)
    sentinels = {q8: check_tier_sentinels(q8) for q8 in (False, True)}
    out["ragged_paged_attention_tier"] = check_tier_ragged(32, 8, 128, bf16)
    out["ragged_paged_attention_q8_tier"] = check_tier_ragged(
        32, 8, 128, bf16, q8=True)
    check_tier_ragged(32, 8, 128, f32, timed=False)
    check_tier_ragged(28, 4, 128, bf16, timed=False)
    out["paged_demote_q8"] = check_demote(bf16)
    log("phase2 kv tier " + json.dumps({
        k: {f: r.get(f) for f in ("max_abs_err", "ms", "ms_cold", "ms_graph",
                                  "untiered_ms", "bound_ms", "plain_ms",
                                  "ms_block")}
        for k, r in out.items()})
        + f" sentinels bit-exact {sentinels} "
          f"({time.perf_counter() - t0:.1f} s)")
    return out


# ------------------------------------------------------------------ phase 3

def phase3_model():
    """Phase 3's model, one copy for all of its checks: f32, the 8B widths,
    depth 2, weights made on the CPU from seed 0. Returns (cfg, model,
    prompt)."""
    import tempfile

    import torch

    from localai_tpu_torch.engine.loader import load_config
    from localai_tpu_torch.models.llama import init_params

    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(dict(CFG_8B, num_hidden_layers=2), f)
        cfg = load_config(d, dtype="float32")
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    log(f"phase3: f32 weights (8B widths, 2 layers) made on the CPU in "
        f"{time.perf_counter() - t0:.1f} s")
    prompt = [(i * 7919) % cfg.vocab_size for i in range(1, 24)]
    return cfg, model, prompt


def _card_vs_cpu_run(cfg, model, prompt, device):
    """The greedy request through the port on `device`: first-step logits
    of prefill on the dense cache and through a shuffled block table, then
    16 tokens from the dense, the paged and the ragged engine."""
    import torch

    from localai_tpu_torch.engine.engine import (
        Engine, EngineConfig, GenRequest,
    )
    from localai_tpu_torch.models.llama import init_kv_cache, prefill
    from localai_tpu_torch.ops.paged import init_paged
    from localai_tpu_torch.ops.rope import rope_table
    from localai_tpu_torch.ops.sampling import SamplingParams

    ec = EngineConfig(max_slots=1, max_context=128, prefill_buckets=(32,),
                      prefill_chunk=32)
    # paged: 256-token context (MAXB 2) over a 5-block pool; the prefill
    # check writes through a shuffled table
    ec_paged = dataclasses.replace(ec, max_context=256, kv_pages=5)
    # ragged: two slots over the same pool, 64-row stream, fused loop on
    ec_ragged = dataclasses.replace(ec_paged, max_slots=2,
                                    ragged_token_budget=64,
                                    ragged_loop_steps=16)
    table = [[3, 1]]

    def run_ragged(m, graphs):
        """The ragged engine (fused loop on): the greedy request, and after
        two ticks a 40-token one whose chunks pack beside its decode."""
        eng = Engine(cfg, m, None, ec_ragged, device=device)
        qs = [eng.submit(GenRequest(prompt, SamplingParams(temperature=0.0),
                                    max_tokens=16, ignore_eos=True))[1]]
        for _ in range(2):
            eng.step()
        qs.append(eng.submit(GenRequest(prompt[::-1] + prompt[:17],
                                        SamplingParams(temperature=0.0),
                                        max_tokens=16, ignore_eos=True))[1])
        while eng.step():
            pass
        if eng.metrics["ragged_dispatches"] < 2:
            raise AssertionError("phase3: the ragged engine packed no "
                                 "mixed tick")
        graphs.update(eng.graphs.counters())
        ids = []
        for q in qs:
            ids.append([])
            while not q.empty():
                o = q.get_nowait()
                if o.token_id >= 0:
                    ids[-1].append(o.token_id)
        return ids

    t0 = time.perf_counter()
    m = model.to(device)
    ids = torch.zeros((1, 32), dtype=torch.int32, device=device)
    ids[0, :len(prompt)] = torch.tensor(prompt)
    lens = torch.tensor([len(prompt)], device=device)
    slot = torch.zeros((1,), dtype=torch.int64, device=device)
    cos, sin = rope_table(cfg.rope, 256, device=device)
    kc, vc = init_kv_cache(cfg, 1, 128, device=device)
    pk, pv = init_paged(cfg.num_layers, 5, cfg.num_kv_heads,
                        cfg.head_dim, torch.float32, device=device)
    with torch.no_grad():
        logits = prefill(m, cfg, ids, lens, cos, sin, kc, vc, slot)
        plogits = prefill(m, cfg, ids, lens, cos, sin, pk, pv, slot,
                          table=torch.tensor(table, dtype=torch.int32,
                                             device=device))
    out = {"logits": logits.float().cpu(),
           "paged_logits": plogits.float().cpu()}
    out["graphs"] = {}
    for key, conf in (("tokens", ec), ("paged_tokens", ec_paged)):
        eng = Engine(cfg, m, None, conf, device=device)
        out[key] = [o.token_id for o in eng.generate(GenRequest(
            prompt, SamplingParams(temperature=0.0), max_tokens=16,
            ignore_eos=True))]
        out["graphs"].update(eng.graphs.counters())
    out["ragged_tokens"] = run_ragged(m, out["graphs"])
    out["s"] = time.perf_counter() - t0
    return out


def phase3_cpu_side(tok):
    """Phase 3's runs on the CPU (the plain versions), made on a thread of
    their own while phase 1's nvcc processes build the kernels: the model's
    weights (phase3_model), its dense, paged and ragged engines, the draft
    engines of the spec check and the grammar engine. Returns the model,
    the draft and every CPU output, which the card's runs are held to."""
    cfg, model, prompt = phase3_model()
    cs = {"cfg": cfg, "model": model, "prompt": prompt,
          "cpu": _card_vs_cpu_run(cfg, model, prompt, "cpu")}
    cs["dcfg"], cs["draft"] = spec_draft()
    t0 = time.perf_counter()
    cs["spec_cpu"] = {
        path: spec_serve(cfg, model, ec, cs["draft"], cs["dcfg"], "cpu",
                         prompt)
        for path, ec in spec_configs().items()}
    log(f"phase3 spec cpu: dense, paged and ragged draft engines "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cs["grammar_cpu"], _ = grammar_serve(cfg, model, tok, "cpu",
                                         GRAMMAR_CVC_EC)
    cs["grammar_cpu_s"] = time.perf_counter() - t0
    return cs


def phase_card_vs_cpu(cs):
    """f32, 8B widths, depth 2: the same greedy request through the port on
    the CPU (plain versions; phase3_cpu_side's runs) and on the card
    (kernels), with the dense cache and with the paged pool (a shuffled
    block table). Tokens must be equal; first-step logits within 2e-3 (f32
    GEMMs over K up to 14336 summed in another order on the two devices).
    On the card the paged engine must give the dense engine's tokens."""
    cfg, model, prompt, cpu = cs["cfg"], cs["model"], cs["prompt"], cs["cpu"]
    gpu = _card_vs_cpu_run(cfg, model, prompt, "cuda")
    for key in ("", "paged_"):
        err = float((cpu[key + "logits"] - gpu[key + "logits"]).abs().max())
        kind = key.rstrip("_") or "dense"
        log(f"phase3 {kind} cpu tokens  {cpu[key + 'tokens']} "
            f"({cpu['s']:.1f} s both)")
        log(f"phase3 {kind} card tokens {gpu[key + 'tokens']} "
            f"({gpu['s']:.1f} s both)")
        log(f"phase3 {kind} first-step logits max_abs_err {err:.3g} "
            f"(tol 2e-3), |logits| max "
            f"{float(cpu[key + 'logits'].abs().max()):.3g}")
        if (cpu[key + "tokens"] != gpu[key + "tokens"]
                or len(gpu[key + "tokens"]) != 16):
            raise AssertionError(f"{kind}: card and CPU greedy tokens differ")
        if not err <= 2e-3:
            raise AssertionError(f"{kind}: first-step logits differ by {err}")
    if gpu["paged_tokens"] != gpu["tokens"]:
        raise AssertionError("card: paged and dense engines' tokens differ")
    log(f"phase3 ragged cpu tokens  {cpu['ragged_tokens']}")
    log(f"phase3 ragged card tokens {gpu['ragged_tokens']}")
    if (cpu["ragged_tokens"] != gpu["ragged_tokens"]
            or [len(t) for t in gpu["ragged_tokens"]] != [16, 16]):
        raise AssertionError("ragged: card and CPU greedy tokens differ")
    log("phase3 card graph runners " + json.dumps(gpu["graphs"]))
    for path in ("dense", "paged", "rloop"):
        if gpu["graphs"].get(path, {}).get("replays", 0) <= 0:
            raise AssertionError(f"phase3: the card's {path} loop replayed "
                                 f"no CUDA graph")
    spec_card_vs_cpu(cs, gpu["tokens"])
    resume_card_check(cfg, model)


def _preempt_run(eng, reqs, stop_at=None):
    """Submit `reqs` [(ids, SamplingParams, max_tokens, resume payload)]
    at once and step: to the end, or, with `stop_at`, until every stream
    has that many tokens, then preempt. Returns (token lists, each
    stream's terminal ResumeToken dict or None)."""
    from localai_tpu_torch.engine.engine import GenRequest

    recs = []
    for ids, sp, n, resume in reqs:
        _, q = eng.submit(GenRequest(list(ids), sp, max_tokens=n,
                                     ignore_eos=True, resume=resume))
        recs.append({"q": q, "toks": [], "end": None})
    while any(r["end"] is None for r in recs):
        eng.step()
        if stop_at is not None and all(len(r["toks"]) >= stop_at
                                       for r in recs):
            eng.preempt()
            stop_at = None
        for r in recs:
            while not r["q"].empty():
                o = r["q"].get_nowait()
                if o.token_id >= 0:
                    r["toks"].append(o.token_id)
                if o.finished:
                    r["end"] = o
    return [r["toks"] for r in recs], [r["end"].resume for r in recs]


def resume_card_check(cfg, model):
    """Phase 3's preemption check, on the card: a paged engine with an int8
    pool and the host tier serves a greedy and a seeded-sampled request
    (300-token prompts: two full blocks each); once both have streamed 8
    tokens it is preempted, and a fresh engine adopting its pool resumes
    both ResumeTokens. got + rest must equal the uninterrupted streams
    token for token, both resumes readmitting their blocks."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig
    from localai_tpu_torch.engine.resume import ResumeToken
    from localai_tpu_torch.ops.sampling import SamplingParams

    ec = EngineConfig(max_slots=2, max_context=512, prefill_buckets=(64,),
                      prefill_chunk=256, kv_pages=8, cache_type="int8",
                      decode_loop=8, decode_block=4)
    n = 32
    reqs = [([(i * 7919 + s) % cfg.vocab_size for i in range(1, 301)], sp)
            for s, sp in ((0, SamplingParams(temperature=0.0)),
                          (5, SamplingParams(temperature=0.8, top_k=40,
                                             seed=7)))]
    plan = [(ids, sp, n, None) for ids, sp in reqs]

    def engine(**kw):
        return Engine(cfg, model, None, dataclasses.replace(ec, **kw),
                      device="cuda")

    want, _ = _preempt_run(engine(), plan)
    eng = engine(kv_host_bytes=1 << 30)
    got, man = _preempt_run(eng, plan, stop_at=8)
    toks = [ResumeToken.from_dict(m) for m in man]
    fresh = Engine(cfg, model, None, ec, kvhost=eng._kvhost, device="cuda")
    rest, _ = _preempt_run(fresh, [
        (t.resume_prompt, sp, n - t.generated, t.payload())
        for t, (_, sp) in zip(toks, reqs)])
    res = {"emitted_at_preempt": [t.generated for t in toks],
           "spilled_blocks": eng.metrics["preempt_spilled_blocks"],
           "resume_readmits": fresh.metrics["resume_readmits"],
           "greedy_equal": got[0] + rest[0] == want[0],
           "sampled_equal": got[1] + rest[1] == want[1],
           "sampled_key": toks[1].key}
    log("phase3 preempt/resume (int8 pool, fresh engine adopting the "
        "pool) " + json.dumps(res))
    if not (res["greedy_equal"] and res["sampled_equal"]
            and res["resume_readmits"] == 2 and toks[1].key):
        raise AssertionError("phase3: a preempted and resumed stream is not "
                             "the uninterrupted one")


# phase 3's spec streams (the CPU's spec step samples over V = 128256 with
# two sorts a window position: about 0.8 s a step)
SPEC_CHECK_TOKENS = 10


def spec_draft():
    """Phase 3's draft: 1 f32 layer at Llama-3.2-1B's widths, weights made
    on the CPU from seed 1. Returns (dcfg, draft)."""
    import tempfile

    import torch

    from localai_tpu_torch.engine.loader import load_config
    from localai_tpu_torch.models.llama import init_params

    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(dict(CFG_1B, num_hidden_layers=1), f)
        dcfg = load_config(d, dtype="float32")
    return dcfg, init_params(dcfg, seed=1, dtype=torch.float32, device="cpu")


def spec_configs():
    """Phase 3's draft engines: dense, paged and ragged, gamma 4."""
    from localai_tpu_torch.engine.engine import EngineConfig

    base = dict(max_slots=2, max_context=256, prefill_buckets=(32,),
                prefill_chunk=32, gamma=SPEC_GAMMA)
    return {"dense": EngineConfig(**base),
            "paged": EngineConfig(**base, kv_pages=5),
            "ragged": EngineConfig(**base, kv_pages=5,
                                   ragged_token_budget=64)}


def spec_serve(cfg, model, ec, dm, dc, device, prompt):
    """The greedy spec stream of `prompt` (and, on the ragged engine, a
    second request joining mid-decode), SPEC_CHECK_TOKENS tokens each, with
    the draft (dc, dm); both models moved to `device`. Returns (token
    lists, draft metrics)."""
    from localai_tpu_torch.engine.engine import Engine, GenRequest
    from localai_tpu_torch.ops.sampling import SamplingParams

    model.to(device)
    dm.to(device)
    eng = Engine(cfg, model, None, ec, draft=(dc, dm), device=device)
    qs = [eng.submit(GenRequest(prompt, SamplingParams(temperature=0.0),
                                max_tokens=SPEC_CHECK_TOKENS,
                                ignore_eos=True))[1]]
    if ec.ragged_token_budget:
        for _ in range(2):
            eng.step()
        qs.append(eng.submit(GenRequest(
            prompt[::-1] + prompt[:17], SamplingParams(temperature=0.0),
            max_tokens=SPEC_CHECK_TOKENS, ignore_eos=True))[1])
    while eng.step():
        pass
    ids = []
    for q in qs:
        ids.append([])
        while not q.empty():
            o = q.get_nowait()
            if o.token_id >= 0:
                ids[-1].append(o.token_id)
    return ids, {k: eng.metrics[k] for k in (
        "draft_proposed", "draft_accepted", "tokens_by_path__spec")}


def spec_card_vs_cpu(cs, plain_tokens):
    """Speculative decoding on phase 3's f32 target (8B widths, 2 layers)
    with a 1-layer f32 draft at Llama-3.2-1B's widths (spec_draft): the
    greedy spec streams on the card equal the CPU's (phase3_cpu_side's),
    dense, paged and ragged (a second request joins the ragged engine mid-
    decode), 10 tokens each; and with the target as its own draft every
    proposal is accepted (gamma a step) and the stream is the plain
    engine's on the card (`plain_tokens`, its first 10)."""
    cfg, model, prompt = cs["cfg"], cs["model"], cs["prompt"]
    draft, dcfg = cs["draft"], cs["dcfg"]
    ecs = spec_configs()
    t0 = time.perf_counter()
    card = {path: spec_serve(cfg, model, ec, draft, dcfg, "cuda", prompt)
            for path, ec in ecs.items()}
    log(f"phase3 spec cuda: dense, paged and ragged draft engines "
        f"{time.perf_counter() - t0:.1f} s")
    for path in ecs:
        (cpu, mc), (toks, mg) = cs["spec_cpu"][path], card[path]
        log(f"phase3 spec {path} cpu tokens {cpu} card tokens {toks} "
            f"card metrics {json.dumps(mg)}")
        if cpu != toks or any(len(t) != SPEC_CHECK_TOKENS for t in toks):
            raise AssertionError(f"phase3 spec {path}: card and CPU greedy "
                                 f"tokens differ")
    perfect = {}
    for path, ec in ecs.items():
        toks, m = spec_serve(cfg, model, ec, model, cfg, "cuda", prompt)
        perfect[path] = dict(m, tokens=toks[0])
        if not (toks[0] == plain_tokens[:SPEC_CHECK_TOKENS]
                and m["draft_accepted"] == m["draft_proposed"] > 0):
            raise AssertionError(f"phase3 spec {path}: the perfect draft "
                                 f"did not accept gamma a step with the "
                                 f"plain stream {perfect[path]}")
    log("phase3 spec perfect draft (draft = target) " + json.dumps(perfect))
    del cs["draft"]


# ------------------------------------------------------------ phase 3, graphs

# the fused loops' graph check: engines at the 8B widths (depth cut to 2
# layers), four requests each — greedy, seeded top-k, a 300-token prompt
# that prefills in chunks, seeded top-p through the full sort — of
# GRAPH_TOKENS tokens, three segments of the loop
GRAPH_EC = {
    "dense": dict(max_slots=4, max_context=1024, prefill_buckets=(64, 256),
                  prefill_chunk=256),
    "paged": dict(max_slots=4, max_context=1024, prefill_buckets=(64, 256),
                  prefill_chunk=256, kv_pages=33),
    "rloop": dict(max_slots=4, max_context=1024, prefill_buckets=(64, 256),
                  prefill_chunk=128, kv_pages=33, ragged_token_budget=128),
}
GRAPH_REQUESTS = [
    (17, dict(temperature=0.0)),
    (40, dict(temperature=0.8, top_k=40, seed=11)),
    (300, dict(temperature=0.0)),
    (90, dict(temperature=0.9, top_k=0, top_p=0.9, seed=5)),
]
GRAPH_TOKENS = 24


def _serve_graph_case(cfg, params, ec, eager, label):
    """GRAPH_REQUESTS through an in-process Engine, its loop segments as
    graph replays or (eager=True) each called directly (EagerSegments, the
    runner of an engine on a mesh; here a check's); checks the weight
    GEMMs' launches against the forwards run. Returns
    ([(tokens, logprobs)], runner counters)."""
    from localai_tpu_torch.engine.engine import (
        Engine, EngineConfig, GenRequest,
    )
    from localai_tpu_torch.engine.graphs import EagerSegments
    from localai_tpu_torch.ops.kernels import launch_counts
    from localai_tpu_torch.ops.quant import is_quantized
    from localai_tpu_torch.ops.sampling import SamplingParams

    eng = Engine(cfg, params, None, EngineConfig(**ec), device="cuda")
    if eager:
        eng.graphs = EagerSegments(eng.device)
    eng.warmup()
    c0, m0, g0 = launch_counts(), dict(eng.metrics), eng.graphs.counters()
    qs = [eng.submit(GenRequest(prompt_ids(i, n, salt=7), SamplingParams(**sp),
                                max_tokens=GRAPH_TOKENS, ignore_eos=True,
                                logprobs=True))[1]
          for i, (n, sp) in enumerate(GRAPH_REQUESTS)]
    for _ in range(10000):
        if not eng.step():
            break
    launched = {k: v - c0[k] for k, v in launch_counts().items()}
    check_weight_gemms(label, launched, cfg.num_layers,
                       *forward_counts(m0, eng.metrics,
                                       graph_delta(g0, eng.graphs.counters())),
                       is_quantized(params.layers[0]["wq"]))
    out = []
    for q in qs:
        toks, lps = [], []
        while not q.empty():
            o = q.get_nowait()
            if o.token_id >= 0:
                toks.append(o.token_id)
                lps.append(o.logprob)
        out.append((toks, lps))
    return out, eng.graphs.counters()


def phase_graphs():
    """The fused loops' CUDA graphs against their eager segments, on the
    card: the same requests served twice by fresh engines at the 8B widths
    (2 layers, weights from a seed), once through graph replays and once
    with each segment run eagerly (a test helper); tokens and logprobs must
    be equal, bit for bit, for the dense, paged and ragged (pack-free and
    mixed) loops, in bf16 and in the int8 recipe (int8 weights + KV),
    greedy and seeded-sampled. The graphed runs must have replayed."""
    import tempfile

    import torch

    from localai_tpu_torch.engine.loader import load_config
    from localai_tpu_torch.models.llama import init_params
    from localai_tpu_torch.ops.quant import quantize_params

    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(dict(CFG_8B, num_hidden_layers=2), f)
        cfg = load_config(d, dtype="bfloat16")
    for recipe in ("bf16", "int8"):
        params = init_params(cfg, seed=0, device="cuda")
        kv = ""
        if recipe == "int8":
            params, kv = quantize_params(params), "int8"
        for path, ec in GRAPH_EC.items():
            ec = dict(ec, cache_type=kv)
            label = f"phase3 graphs {recipe} {path}"
            graphed, counters = _serve_graph_case(cfg, params, ec, False,
                                                  label)
            eager, eager_counters = _serve_graph_case(cfg, params, ec, True,
                                                      label + " eager")
            res = {
                "tokens_equal": [g[0] == e[0]
                                 for g, e in zip(graphed, eager)],
                "logprobs_equal": [g[1] == e[1]
                                   for g, e in zip(graphed, eager)],
                "tokens": [len(g[0]) for g in graphed],
                "graphs": counters.get(path), "eager_runner": eager_counters}
            log(f"phase3 graphs {recipe} {path} " + json.dumps(res))
            if not all(res["tokens_equal"]) or not all(res["logprobs_equal"]):
                raise AssertionError(f"phase3 graphs {recipe} {path}: graph "
                                     f"replays and eager segments differ")
            if res["tokens"] != [GRAPH_TOKENS] * len(GRAPH_REQUESTS):
                raise AssertionError(f"phase3 graphs {recipe} {path}: "
                                     f"token counts {res['tokens']}")
            if not counters.get(path, {}).get("replays"):
                raise AssertionError(f"phase3 graphs {recipe} {path}: no "
                                     f"graph replayed")
        del params
        torch.cuda.empty_cache()
    log("phase3 graphs: replays equal the eager segments")


# ------------------------------------------------------------------ phase 4

class _Client:
    """Minimal gRPC client of the backend proto (the port's messages)."""

    def __init__(self, addr):
        import grpc

        from localai_tpu_torch.backend import pb

        self.pb = pb
        self.channel = grpc.insecure_channel(addr)
        grpc.channel_ready_future(self.channel).result(timeout=60)

    def _rpc(self, name, req_cls, resp_cls, stream=False):
        make = self.channel.unary_stream if stream \
            else self.channel.unary_unary
        return make(f"/{self.pb.SERVICE_NAME}/{name}",
                    request_serializer=req_cls.SerializeToString,
                    response_deserializer=resp_cls.FromString)

    def load(self, **kw):
        return self._rpc("LoadModel", self.pb.ModelOptions, self.pb.Result)(
            self.pb.ModelOptions(**kw), timeout=1800)

    def stream(self, **kw):
        return self._rpc("PredictStream", self.pb.PredictOptions,
                         self.pb.Reply, stream=True)(
            self.pb.PredictOptions(**kw), timeout=600)

    def metrics(self):
        r = self._rpc("GetMetrics", self.pb.MetricsRequest,
                      self.pb.MetricsResponse)(self.pb.MetricsRequest())
        return dict(r.metrics)

    def embedding(self, **kw):
        return self._rpc("Embedding", self.pb.PredictOptions,
                         self.pb.EmbeddingResult)(
            self.pb.PredictOptions(**kw), timeout=600)

    def rerank(self, **kw):
        return self._rpc("Rerank", self.pb.RerankRequest,
                         self.pb.RerankResult)(
            self.pb.RerankRequest(**kw), timeout=600)

    def tokenize(self, prompt):
        return self._rpc("TokenizeString", self.pb.PredictOptions,
                         self.pb.TokenizationResponse)(
            self.pb.PredictOptions(prompt=prompt), timeout=60)

    def close(self):
        self.channel.close()


REQUESTS = [  # (prompt length, sampling) — 700 prefills in 512-token chunks
    (1, dict(temperature=0.0)),
    (17, dict(temperature=0.8, top_k=40, seed=11)),
    (300, dict(temperature=0.0)),
    (700, dict(temperature=0.9, top_p=0.9, seed=5)),
]
NEW_TOKENS = 64


def prompt_ids(i, n, salt=0):
    """Request i's n prompt ids; a new salt misses the prompt cache."""
    vocab = CFG_8B["vocab_size"]
    return [(7 * i + 13 * j + salt) % (vocab - 1) + 1 for j in range(n)]


def drive_requests(client, salt=0, requests=None, tokens=NEW_TOKENS):
    """`requests` ([(prompt length or ids, sampling)], default REQUESTS) at
    once over `client`, `tokens` new tokens each. Returns ([(ttft_s, token
    ids, logprobs, last reply, prompt ids)], wall seconds). The prompt ids
    depend on `salt`, so a new salt misses the prompt cache."""
    import threading

    requests = REQUESTS if requests is None else requests
    results = [None] * len(requests)

    def one(i, n, sp):
        ids = list(n) if isinstance(n, list) else prompt_ids(i, n, salt)
        ts = time.perf_counter()
        ttft, toks, lps, last = None, [], [], None
        for c in client.stream(prompt_ids=ids, tokens=tokens,
                               ignore_eos=True, logprobs=True, **sp):
            if c.token_ids and ttft is None:
                ttft = time.perf_counter() - ts
            toks += list(c.token_ids)
            lps += list(c.logprobs)
            last = c
        results[i] = (ttft, toks, lps, last, ids)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i, n, sp))
               for i, (n, sp) in enumerate(requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, time.perf_counter() - t0


def check_wave(name, results, vocab=CFG_8B["vocab_size"]):
    """Every request finished with `length` and NEW_TOKENS in-vocab tokens
    with finite logprobs."""
    for i, res in enumerate(results):
        if res is None:
            raise RuntimeError(f"{name}: request {i} failed")
        ttft, toks, lps, last, _ = res
        if (last.finish_reason != "length" or last.tokens != NEW_TOKENS
                or len(toks) != NEW_TOKENS):
            raise AssertionError(
                f"{name} request {i}: finish {last.finish_reason!r} "
                f"tokens {last.tokens}/{len(toks)}")
        if not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"{name}: token id out of vocab")
        if not all(x == x and abs(x) < 1e30 for x in lps):
            raise AssertionError(f"{name}: non-finite logprob")


def wave_stats(name, results, wall, m0, m1, before, after, requests):
    """One wave's readings: tok/s, TTFT, dispatches, launches."""
    import statistics

    import torch

    ttfts = [r[0] for r in results]
    dd = m1["decode_dispatches"] - m0["decode_dispatches"]
    ds = m1["decode_steps_dispatched"] - m0["decode_steps_dispatched"]
    gen = m1["tokens_generated"] - m0["tokens_generated"]
    return {
        "recipe": name, "requests": len(requests),
        "prompt_lengths": [n if isinstance(n, int) else len(n)
                           for n, _ in requests],
        "new_tokens_each": NEW_TOKENS, "tokens": int(gen),
        "wall_s": wall, "tok_s": gen / wall,
        "ttft_p50_ms": statistics.median(ttfts) * 1e3,
        "ttft_ms": sorted(t * 1e3 for t in ttfts),
        "decode_dispatches": int(dd), "decode_steps": int(ds),
        "loop_tokens": int(m1["tokens_by_path__loop"]
                           - m0["tokens_by_path__loop"]),
        "steps_per_dispatch": ds / max(dd, 1),
        "launches_during_requests": {k: after[k] - before[k]
                                     for k in after},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }


def graph_delta(before, after):
    """The graph runner's counters gained between two readings, by path."""
    return {p: {k: v - before.get(p, {}).get(k, 0) for k, v in c.items()}
            for p, c in after.items()}


# the projections w8a16_matmul runs a layer a forward in the int8 recipe
# (a Mixtral layer: the four attention projections, and moe_w8_matmul
# once for each of its three expert stacks)
PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
MOE_PROJECTIONS = ("wq", "wk", "wv", "wo")
EXPERT_STACKS = ("moe_w1", "moe_w2", "moe_w3")


def forward_counts(m0, m1, graphs):
    """(forwards, forwards that return logits) an engine ran between two
    readings of its metrics: admission prefills, chunked-prefill extends
    (a non-final chunk returns no logits), decode steps (a ragged pack
    counts as one) and its graphs' inert warm-up steps (`graphs`: the
    runner's counters gained, by path)."""
    def gained(k):
        return int(m1[k] - m0[k])

    mid = gained("prefill_chunks_mid")
    forwards = (gained("admit_dispatches") + mid
                + gained("prefill_chunks_final")
                + gained("decode_steps_dispatched")
                + sum(g.get("warmup_steps", 0) for g in graphs.values()))
    return forwards, forwards - mid


def check_weight_gemms(label, launched, layers, forwards, logit_forwards,
                       int8, moe=False, int4=False):
    """The weight GEMM kernels launched once a projection a layer a forward
    (w8a16_matmul, int8 recipe only; w4a16_matmul, int4 only), once an
    expert stack a layer a forward (moe_w8_matmul / moe_w4_matmul, a
    Mixtral model's int8 / int4 recipe only) and once a forward that
    returns logits (head_matmul: the untied bf16 or int8 head;
    head_matmul_int4: the int4 head); the other width's kernels never."""
    proj = MOE_PROJECTIONS if moe else PROJECTIONS
    projs = len(proj) * layers * forwards
    stacks = len(EXPERT_STACKS) * layers * forwards if moe else 0
    want = {"w8a16_matmul": projs if int8 else 0,
            "moe_w8_matmul": stacks if int8 else 0,
            "head_matmul": 0 if int4 else logit_forwards,
            "w4a16_matmul": projs if int4 else 0,
            "moe_w4_matmul": stacks if int4 else 0,
            "head_matmul_int4": logit_forwards if int4 else 0}
    for k, n in want.items():
        if launched[k] != n:
            raise AssertionError(
                f"{label}: {k} launched {launched[k]} times, not {n} "
                f"({forwards} forwards, {logit_forwards} with logits, "
                f"{layers} layers)")


def check_fused_path(label, graphs, path, loop_tokens, launched, kernels,
                     layers, steps):
    """A run's fused loop went through graph replays whenever it served
    tokens (`loop_tokens`), and each of `kernels` launched once a layer a
    decode step: `steps` decode steps (replayed, eager or the graphs'
    inert warm-up steps alike)."""
    g = graphs.get(path, {})
    if loop_tokens > 0 and g.get("replays", 0) <= 0:
        raise AssertionError(f"{label}: the fused {path} loop served "
                             f"{loop_tokens} tokens without a graph replay")
    want = layers * (steps + g.get("warmup_steps", 0))
    for k in kernels:
        if launched[k] != want:
            raise AssertionError(
                f"{label}: {k} launched {launched[k]} times, not {layers} "
                f"layers x ({steps} decode steps + {g.get('warmup_steps', 0)}"
                f" warm-up steps) = {want}")


def serve_recipe(name, model_dir, load_kw, phase="phase4", load_opts=None,
                 waves=None, then=None, on_load=None):
    """Start the port's gRPC backend on 127.0.0.1, load the model, drive
    each wave of requests (default: the four REQUESTS) after the previous
    one finished, and check them. on_load(servicer), if given, runs once
    the model is loaded, before the first wave. Then, with the model still
    loaded, call then(client, servicer, readings) if given. Returns the
    wave's readings (its requests' results under "_results"), or with
    several waves the list of them."""
    import torch

    from localai_tpu_torch.backend.server import serve
    from localai_tpu_torch.ops.kernels import launch_counts

    load_opts = load_opts or dict(parallel=4, context_size=2048)
    waves = waves or [REQUESTS]
    server, servicer, port = serve("127.0.0.1:0", device="cuda")
    client = _Client(f"127.0.0.1:{port}")
    try:
        t0 = time.perf_counter()
        r = client.load(model=model_dir, **load_opts, **load_kw)
        if not r.success:
            raise RuntimeError(f"{name}: LoadModel failed: {r.message}")
        log(f"{phase} {name}: LoadModel (weights + warmup) "
            f"{time.perf_counter() - t0:.1f} s")
        if on_load is not None:
            on_load(servicer)
        outs = []
        for w, requests in enumerate(waves):
            before = launch_counts()
            g0 = servicer.engine.graphs.counters()
            m0 = client.metrics()
            results, wall = drive_requests(client, requests=requests)
            m1 = client.metrics()
            g1 = servicer.engine.graphs.counters()
            after = launch_counts()
            check_wave(f"{name} wave {w + 1}", results)
            out = wave_stats(name, results, wall, m0, m1, before, after,
                             requests)
            out["graphs"] = graph_delta(g0, g1)
            out["forwards"], out["logit_forwards"] = forward_counts(
                m0, m1, out["graphs"])
            out["metrics_before"], out["metrics_after"] = m0, m1
            out["_results"] = results
            outs.append(out)
            log(f"{phase} {name}" + (f" wave {w + 1} " if len(waves) > 1
                                     else " ")
                + json.dumps({k: v for k, v in out.items()
                              if not k.startswith(("metrics_", "_"))}))
        outs = outs if len(waves) > 1 else outs[0]
        if then is not None:
            then(client, servicer, outs)
        return outs
    finally:
        client.close()
        servicer.shutdown()
        server.stop(grace=1).wait(10)
        servicer.engine = None
        import gc

        gc.collect()
        torch.cuda.empty_cache()


def phase_main_path():
    """The main path: a synthetic Llama-3.1-8B checkpoint served by the
    port's gRPC backend, bf16 then the int8 recipe."""
    import tempfile

    import torch

    from localai_tpu_torch.ops.kernels import launch_counts, \
        reset_launch_counts

    os.environ["LOCALAI_ALLOW_SYNTHETIC"] = "1"
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(dict(CFG_8B, localai_synthetic=True), f)
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        bf16 = serve_recipe("bf16", d, dict(dtype="bfloat16"))
        torch.cuda.reset_peak_memory_stats()
        int8 = serve_recipe("int8", d, dict(dtype="int8",
                                            cache_type_key="int8",
                                            cache_type_value="int8"))
        counts = launch_counts()
    PLAIN["dense", "bf16"], PLAIN["dense", "int8"] = bf16, int8
    log("phase4 launches on the main path " + json.dumps(counts))
    for k in ("flash_prefill", "ragged_decode", "ragged_decode_q8"):
        if counts[k] <= 0:
            raise AssertionError(f"the main path never launched {k}")
    if bf16["launches_during_requests"]["ragged_decode_q8"] or \
            int8["launches_during_requests"]["ragged_decode"]:
        raise AssertionError("decode kernel variant does not match the "
                             "recipe's KV cache")
    for name, out, k in (("bf16", bf16, "ragged_decode"),
                         ("int8", int8, "ragged_decode_q8")):
        check_fused_path(f"phase4 {name}", out["graphs"], "dense",
                         out["loop_tokens"], out["launches_during_requests"],
                         (k,), CFG_8B["num_hidden_layers"],
                         out["decode_steps"])
        check_weight_gemms(f"phase4 {name}", out["launches_during_requests"],
                           CFG_8B["num_hidden_layers"], out["forwards"],
                           out["logit_forwards"], name == "int8")
    return counts


# ------------------------------------------------------------------ phase 5

PAGED_LOAD = dict(parallel=8, context_size=4096, kv_pages=129)
SHARED = 640          # wave 1's request 5; wave 2 extends its prompt
PAGED_WAVE1 = [
    (1, dict(temperature=0.0)),
    (17, dict(temperature=0.8, top_k=40, seed=11)),
    (300, dict(temperature=0.0)),
    (700, dict(temperature=0.9, top_p=0.9, seed=5)),
    (1500, dict(temperature=0.0)),
    (SHARED, dict(temperature=0.7, top_k=50, seed=21)),
]
# wave 3: eight fresh 2000-token prompts. Each reserves 17 blocks (2000
# prompt + 64 new + the engine's 33-token pipelining margin, over 128), so
# eight need 136 of the 128 usable blocks: admission reclaims the blocks
# that waves 1 and 2 left retained, and the last request defers until one
# finishes
PRESSURE_PROMPT, PRESSURE_REQUESTS = 2000, 8

# teacher-forced reference check (check_reference): the served greedy
# token's reference logit must be within REF_MARGIN of the row's largest,
# and its served logprob within REF_LP_TOL of the reference's. The model's
# logits are about N(0, 1) per entry (unit-RMS final norm, weights of std
# 1/sqrt(fan_in)); the two computations round to bf16 in different places
# (kernels vs the plain forward), which moves a logit by a few hundredths
REF_MARGIN, REF_LP_TOL = 0.25, 0.25


def _tail(seed, n=40):
    vocab = CFG_8B["vocab_size"]
    return [(104729 * seed + 31 * j) % (vocab - 1) + 1 for j in range(n)]


def paged_wave2():
    """Two greedy requests: wave 1's 640-token prompt plus two different
    40-token tails — one reuses the retained slot, the other borrows its 5
    full blocks through the prefix index (copy-on-write)."""
    return [(prompt_ids(5, SHARED) + _tail(t), dict(temperature=0.0))
            for t in (1, 2)]


def paged_wave3():
    """Pool pressure: PRESSURE_REQUESTS greedy requests with fresh
    PRESSURE_PROMPT-token prompts (a salt no earlier wave used)."""
    return [(prompt_ids(i, PRESSURE_PROMPT, salt=3), dict(temperature=0.0))
            for i in range(PRESSURE_REQUESTS)]


def paged_reference_cases(outs):
    """Phase 5's teacher-forced cases: wave 1's 1500-token request (12
    blocks through the table) and both wave-2 requests (the retained slot
    and the borrowed blocks); the planted fault is wave 2's second
    request's tokens after a different 640-token prefix, what a table
    pointing at the wrong blocks would attend to."""
    w1, w2 = outs[0]["_results"], outs[1]["_results"]
    cases = {label: (r[4], r[1], r[2]) for label, r in (
        ("wave1 1500-token", w1[4]), ("wave2 request 1", w2[0]),
        ("wave2 request 2", w2[1]))}
    _, toks, lps, _, ids = w2[1]
    fault = (prompt_ids(0, SHARED, salt=99) + ids[SHARED:], toks, lps)
    return cases, fault


@contextlib.contextmanager
def plain_weight_gemms():
    """Within: the model's projections, int8 or int4 expert stacks and lm
    head run the weight GEMMs' plain versions (unpack, cast +
    torch.matmul, dequantize + einsum) on the card too, for the
    teacher-forced reference, which
    launches none of the port's kernels. A check's own device, never the
    serving path's."""
    from localai_tpu_torch.models import llama
    from localai_tpu_torch.ops import kernels, quant

    sites = ((quant, "w8a16_matmul"), (quant, "w4a16_matmul"),
             (llama, "head_matmul"), (llama, "moe_w8_matmul"),
             (llama, "moe_w4_matmul"))
    saved = [getattr(mod, name) for mod, name in sites]
    for mod, name in sites:
        setattr(mod, name, getattr(kernels, name + "_plain"))
    try:
        yield
    finally:
        for (mod, name), fn in zip(sites, saved):
            setattr(mod, name, fn)


def check_reference(name, engine, cases, fault, phase="phase5",
                    grammar=None, margin=None, mm=None):
    """Hold greedy requests served on the paged or ragged path against a
    teacher-forced reference: the prompt plus the served tokens go through
    the port's plain forward (models.llama.extend over a dense cache — plain
    attention, no block table, none of the paged or ragged kernels, and the
    weight GEMMs' plain versions) in one window, which gives the logits
    that predicted each served token. Greedy
    serving picks each row's argmax, so the served token's reference logit
    must be within REF_MARGIN of the row's largest (gap) and its served
    logprob within REF_LP_TOL of the reference's. `cases`: {label: (prompt
    ids, served tokens, served logprobs)}; `fault`: served tokens and
    logprobs under a WRONG prompt, which must fail. `grammar`: the GBNF
    the cases were served under; each reference row is then masked to the
    tokens the grammar allowed there (the port's matcher), as the sampler
    masked the served row. `margin`: the gap and logprob bound in place
    of REF_MARGIN and REF_LP_TOL (phase 12's top-k routed models). `mm`:
    {label: (image feature rows [K, H], their prompt positions [K])} of
    multimodal cases (phase 15): the reference forward is fed the same
    rows through extend's inject; the planted fault takes none."""
    import numpy as np
    import torch

    from localai_tpu_torch.models.llama import extend, init_kv_cache

    gap_tol, lp_tol = (REF_MARGIN, REF_LP_TOL) if margin is None \
        else (margin, margin)
    from localai_tpu_torch.ops.kernels import launch_counts

    cfg, dev = engine.cfg, engine.device

    def reference(ids, toks, rows=None):
        seq = list(ids) + list(toks[:-1])
        kc, vc = init_kv_cache(cfg, 1, len(seq),
                               cache_type=engine.ec.cache_type, device=dev)
        inject = None
        if rows is not None:
            emb, pos = rows
            p = torch.as_tensor(np.asarray(pos), device=dev)
            extra = torch.zeros((1, len(seq), emb.shape[1]), device=dev)
            extra[0, p] = torch.as_tensor(np.asarray(emb, np.float32),
                                          device=dev)
            is_embed = torch.zeros((1, len(seq)), dtype=torch.bool,
                                   device=dev)
            is_embed[0, p] = True
            inject = (extra, is_embed)
        with torch.no_grad():
            logits = extend(engine.params, cfg,
                            torch.tensor([seq], dtype=torch.int32,
                                         device=dev),
                            torch.zeros((1,), dtype=torch.int32, device=dev),
                            engine._cos, engine._sin, kc, vc, inject=inject)
        return logits[0, len(ids) - 1:].float()  # row i predicted toks[i]

    # the grammar's allowed rows by served tokens: the planted fault
    # serves a case's tokens again, and their rows (a host mask walk over
    # the vocabulary a token) are the case's
    rows = {}

    def readings(ref, toks, lps):
        std = float(ref.std(1).mean())
        if grammar:
            key = tuple(toks)
            if key not in rows:
                rows[key] = _grammar_rows(engine, grammar, toks)
            ref = ref.masked_fill(~rows[key], float("-inf"))
        t = torch.tensor(toks, dtype=torch.int64, device=dev)[:, None]
        gap = ref.max(1).values - ref.gather(1, t)[:, 0]
        lp_ref = torch.log_softmax(ref, -1).gather(1, t)[:, 0]
        dlp = (lp_ref - torch.tensor(lps, device=dev)).abs()
        return {"max_gap": float(gap.max()),
                "argmax_equal": int((gap == 0).sum()), "tokens": len(toks),
                "max_dlogprob": float(dlp.max()), "logit_std": std}

    before = launch_counts()
    mm = mm or {}
    with plain_weight_gemms():
        out = {label: readings(reference(ids, toks, mm.get(label)), toks,
                               lps)
               for label, (ids, toks, lps) in cases.items()}
        ids, toks, lps = fault
        out["planted fault"] = readings(reference(ids, toks), toks, lps)
    if launch_counts() != before:
        raise AssertionError("the reference forward launched a kernel")
    log(f"{phase} {name} reference (margin {gap_tol}, logprob tol "
        f"{lp_tol}) " + json.dumps(out))
    for label, r in out.items():
        ok = r["max_gap"] <= gap_tol and r["max_dlogprob"] <= lp_tol
        if label == "planted fault" and ok:
            raise AssertionError(f"{phase} {name}: the reference check does "
                                 f"not reject the planted fault")
        if label != "planted fault" and not ok:
            raise AssertionError(f"{phase} {name} {label}: served greedy "
                                 f"tokens disagree with the reference {r}")
    return out


def phase_paged_path(smi):
    """The paged path at full width: the synthetic Llama-3.1-8B (32 layers)
    served by the port's gRPC backend with parallel=8, context_size=4096
    and kv_pages=129 (128 usable blocks = 16384 tokens, half of what eight
    dense 4096-token slots would hold), bf16 then the int8 recipe; wave 1
    (six requests), wave 2 (two requests sharing wave 1's 640-token
    prompt), wave 3 (pool pressure: reclaim and deferral), then the
    teacher-forced reference check. The launch counts are zeroed just
    before and read just after."""
    import tempfile

    import torch

    from localai_tpu_torch.ops.kernels import launch_counts, \
        reset_launch_counts

    os.environ["LOCALAI_ALLOW_SYNTHETIC"] = "1"
    waves = [PAGED_WAVE1, paged_wave2(), paged_wave3()]
    res = {}
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(dict(CFG_8B, localai_synthetic=True), f)
        reset_launch_counts()
        for name, kw in (("bf16", dict(dtype="bfloat16")),
                         ("int8", dict(dtype="int8", cache_type_key="int8",
                                       cache_type_value="int8"))):
            torch.cuda.reset_peak_memory_stats()
            res[name] = serve_recipe(
                name, d, kw, phase="phase5", load_opts=PAGED_LOAD,
                waves=waves, then=lambda c, s, outs, name=name:
                check_reference(name, s.engine,
                                *paged_reference_cases(outs)))
        counts = launch_counts()
    log("phase5 launches on the paged path " + json.dumps(counts))
    own = PAGED_OWN
    pool = PAGED_LOAD["kv_pages"] - 1
    for name, (w1, w2, w3) in res.items():
        def delta(w, key):
            return w["metrics_after"][key] - w["metrics_before"][key]

        reused = delta(w2, "prompt_tokens_reused")
        peak = w3["metrics_after"]["kv_blocks_peak"]
        launched = {k: sum(w["launches_during_requests"][k]
                           for w in (w1, w2, w3)) for k in counts}
        log(f"phase5 {name} summary " + json.dumps({
            "wave1_tok_s": w1["tok_s"], "wave1_ttft_p50_ms":
            w1["ttft_p50_ms"], "wave2_tok_s": w2["tok_s"],
            "wave2_ttft_p50_ms": w2["ttft_p50_ms"], "wave3_tok_s":
            w3["tok_s"], "wave3_ttft_ms": w3["ttft_ms"],
            "decode_dispatches": sum(w["decode_dispatches"]
                                     for w in (w1, w2, w3)),
            "peak_mem_gb": w3["peak_mem_gb"],
            "wave2_prompt_tokens_reused": reused,
            "wave3_admissions_deferred": delta(w3, "kv_admissions_deferred"),
            "wave3_slots_reclaimed": delta(w3, "kv_slots_reclaimed"),
            "cow_swaps": w3["metrics_after"]["kv_cow_swaps"],
            "kv_blocks_peak": peak, "pool_blocks": pool,
            "flash_prefill_launches": launched["flash_prefill"],
            "card": smi}))
        if reused < 2 * SHARED:
            raise AssertionError(f"phase5 {name}: wave 2 reused {reused} "
                                 f"prompt tokens, expected >= {2 * SHARED}")
        if not 0 < peak <= pool:
            raise AssertionError(f"phase5 {name}: kv_blocks_peak {peak}")
        if delta(w3, "kv_admissions_deferred") <= 0 \
                or delta(w3, "kv_slots_reclaimed") <= 0:
            raise AssertionError(f"phase5 {name}: wave 3 did not put the "
                                 f"pool under pressure (no deferral or no "
                                 f"reclaim)")
        for k in ("ragged_decode", "ragged_decode_q8"):
            if launched[k]:
                raise AssertionError(f"phase5 {name}: the dense {k} "
                                     f"launched on the paged path")
        for k in own[name] + ("flash_prefill",):
            if launched[k] <= 0:
                raise AssertionError(f"phase5 {name}: {k} never launched")
        for k in own["int8" if name == "bf16" else "bf16"]:
            if launched[k]:
                raise AssertionError(f"phase5 {name}: the other recipe's "
                                     f"{k} launched")
        for w, out in enumerate((w1, w2, w3)):
            check_fused_path(f"phase5 {name} wave {w + 1}", out["graphs"],
                             "paged", out["loop_tokens"],
                             out["launches_during_requests"], own[name],
                             CFG_8B["num_hidden_layers"],
                             out["decode_steps"])
            check_weight_gemms(f"phase5 {name} wave {w + 1}",
                               out["launches_during_requests"],
                               CFG_8B["num_hidden_layers"], out["forwards"],
                               out["logit_forwards"], name == "int8")
    return counts


# ------------------------------------------------------------------ phase 6

RAGGED_EC = dict(max_slots=8, max_context=4096, kv_pages=129,
                 ragged_token_budget=192, ragged_loop_steps=16,
                 prefill_buckets=(64, 256), prefill_chunk=256)
RAGGED_WAVES = [
    [(1, dict(temperature=0.0)),
     (17, dict(temperature=0.8, top_k=40, seed=11)),
     (300, dict(temperature=0.0)),
     (700, dict(temperature=0.9, top_p=0.9, seed=5))],
    [(1500, dict(temperature=0.0)),
     (2000, dict(temperature=0.0)),
     (40, dict(temperature=0.8, top_k=40, seed=13)),
     (640, dict(temperature=0.7, top_k=50, seed=21))],
]
PAGED_OWN = {"bf16": ("ragged_decode_paged", "paged_scatter_append"),
             "int8": ("ragged_decode_q8_paged", "paged_scatter_append_q8")}
RAGGED_OWN = {"bf16": ("ragged_paged_attention", "ragged_scatter_append"),
              "int8": ("ragged_paged_attention_q8",
                       "ragged_scatter_append_q8")}


def drive_engine(eng, salt=6):
    """Submit RAGGED_WAVES[0], step the engine until each of its requests
    has streamed a token, submit RAGGED_WAVES[1], step to the end (a new
    salt misses the prefix index). Returns
    ([{ids, toks, lps, ttft, last}], wall seconds); TTFT counts from each
    request's submit()."""
    from localai_tpu_torch.engine.engine import GenRequest
    from localai_tpu_torch.ops.sampling import SamplingParams

    recs = []

    def submit(w):
        for i, (n, sp) in enumerate(RAGGED_WAVES[w]):
            ids = prompt_ids(10 * w + i, n, salt=salt)
            _, q = eng.submit(GenRequest(ids, SamplingParams(**sp),
                                         max_tokens=NEW_TOKENS,
                                         ignore_eos=True, logprobs=True))
            recs.append(dict(ids=ids, q=q, t0=time.perf_counter(),
                             ttft=None, toks=[], lps=[], last=None))

    def pump():
        busy = eng.step()
        now = time.perf_counter()
        for r in recs:
            while not r["q"].empty():
                o = r["q"].get_nowait()
                if o.token_id >= 0:
                    if r["ttft"] is None:
                        r["ttft"] = now - r["t0"]
                    r["toks"].append(o.token_id)
                    r["lps"].append(o.logprob)
                if o.finished:
                    r["last"] = o
        return busy

    t0 = time.perf_counter()
    submit(0)
    for _ in range(10000):
        if all(r["ttft"] is not None for r in recs):
            break
        pump()
    submit(1)
    for _ in range(10000):
        if not pump():
            break
    return recs, time.perf_counter() - t0


def serve_ragged(name, model_dir, dtype, kv_kind, then=None,
                 phase="phase6"):
    """One recipe on the ragged path; returns its readings. `then(eng)`,
    if given, runs after the checks on the same engine; `phase` labels
    the log lines and errors."""
    import gc
    import statistics

    import torch

    from localai_tpu_torch.engine.engine import Engine, EngineConfig
    from localai_tpu_torch.engine.loader import load_config, load_params
    from localai_tpu_torch.ops.kernels import launch_counts, \
        reset_launch_counts

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = load_config(model_dir, dtype=dtype)
    params = load_params(model_dir, cfg, dtype=dtype, device="cuda")
    eng = Engine(cfg, params, None, EngineConfig(**RAGGED_EC,
                                                 cache_type=kv_kind),
                 device="cuda")
    eng.warmup()
    log(f"{phase} {name}: weights + engine + warmup "
        f"{time.perf_counter() - t0:.1f} s")
    try:
        reset_launch_counts()
        g0 = eng.graphs.counters()
        m0 = dict(eng.metrics)
        recs, wall = drive_engine(eng)
        torch.cuda.synchronize()
        counts = launch_counts()
        graphs = graph_delta(g0, eng.graphs.counters())
        vocab = cfg.vocab_size
        for i, r in enumerate(recs):
            last = r["last"]
            if (last is None or last.finish_reason != "length"
                    or len(r["toks"]) != NEW_TOKENS):
                raise AssertionError(f"{phase} {name} request {i}: finish "
                                     f"{last and last.finish_reason} "
                                     f"tokens {len(r['toks'])}")
            if not all(0 <= t < vocab for t in r["toks"]) or not all(
                    x == x and abs(x) < 1e30 for x in r["lps"]):
                raise AssertionError(f"{phase} {name}: bad token or "
                                     f"logprob")
        m = dict(eng.metrics)
        prompts = [len(r["ids"]) for r in recs]
        ttfts = [r["ttft"] for r in recs]
        out = {
            "recipe": name, "model": {
                "layers": cfg.num_layers, "heads": cfg.num_heads,
                "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim},
            "prompt_lengths": prompts,
            "new_tokens_each": NEW_TOKENS,
            "tokens": m["tokens_generated"], "wall_s": wall,
            "tok_s": m["tokens_generated"] / wall,
            "ttft_p50_ms": statistics.median(ttfts) * 1e3,
            "ttft_ms": [t * 1e3 for t in ttfts],
            **{k: m[k] for k in (
                "ragged_dispatches", "ragged_tokens_packed",
                "ragged_prefill_tokens", "budget_utilization",
                "rloop_exit_steps_cap", "rloop_exit_finish",
                "rloop_exit_prefill", "rloop_exit_host_arbitration",
                "decode_dispatches", "decode_steps_dispatched",
                "tokens_by_path__ragged", "tokens_by_path__rloop",
                "kv_blocks_peak")},
            "launches": {k: v for k, v in counts.items() if v},
            "graphs": graphs,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        }
        log(f"{phase} {name} " + json.dumps(out))
        if phase == "phase6":
            PLAIN["ragged", name] = out
        if m["ragged_prefill_tokens"] != sum(prompts):
            raise AssertionError(f"{phase} {name}: ragged_prefill_tokens "
                                 f"{m['ragged_prefill_tokens']} != "
                                 f"{sum(prompts)} prompt tokens")
        if m["rloop_exit_finish"] <= 0 or m["rloop_exit_prefill"] <= 0:
            raise AssertionError(f"{phase} {name}: the fused ragged loop "
                                 f"never exited on a finish or on prefill")
        for k in RAGGED_OWN[name]:
            if counts[k] <= 0:
                raise AssertionError(f"{phase} {name}: {k} never launched")
        # decode iterations ran the paged decode kernels (the mixed ticks'
        # pack ran ragged attention once a layer)
        packs = m["ragged_dispatches"]
        check_fused_path(f"{phase} {name}", graphs, "rloop",
                         m["tokens_by_path__rloop"], counts,
                         PAGED_OWN[name], cfg.num_layers,
                         m["decode_steps_dispatched"] - packs)
        check_fused_path(f"{phase} {name} packs", {}, "rloop", 0, counts,
                         RAGGED_OWN[name], cfg.num_layers, packs)
        check_weight_gemms(f"{phase} {name}", counts, cfg.num_layers,
                           *forward_counts(m0, m, graphs), name == "int8")
        other = RAGGED_OWN["int8" if name == "bf16" else "bf16"]
        for k in ("flash_prefill", "ragged_decode", "ragged_decode_q8") \
                + other:
            if counts[k]:
                raise AssertionError(f"{phase} {name}: {k} launched on "
                                     f"the ragged path")
        cases = {f"{len(r['ids'])}-token": (r["ids"], r["toks"], r["lps"])
                 for r in (recs[2], recs[4], recs[5])}
        fault = (prompt_ids(99, 1500, salt=99), recs[4]["toks"],
                 recs[4]["lps"])
        check_reference(name, eng, cases, fault, phase=phase)
        if then is not None:
            then(eng)
        return out, counts
    finally:
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()


def _serve_ragged_model(cfg_json, phase, smi, then=None):
    """serve_ragged in bf16 then the int8 recipe on a synthetic checkpoint
    of `cfg_json`'s widths; returns the two recipes' launch counts
    summed. `then(name)`, if given, makes each recipe's serve_ragged
    `then`."""
    import tempfile

    os.environ["LOCALAI_ALLOW_SYNTHETIC"] = "1"
    total = {}
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(dict(cfg_json, localai_synthetic=True), f)
        for name, dtype, kv in (("bf16", "bfloat16", ""),
                                ("int8", "int8", "int8")):
            out, counts = serve_ragged(
                name, d, dtype, kv, phase=phase,
                then=None if then is None else then(name))
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
    log(f"{phase} launches on the ragged path " + json.dumps(total)
        + f" card {smi}")
    return total


def phase_ragged_path(smi, grammar_then=None):
    """The ragged path at full width: the synthetic Llama-3.1-8B
    (SERVE_LAYERS of its 32 layers) in the port's Engine with ragged
    continuous batching, bf16 then the int8 recipe; then the same run on a
    synthetic checkpoint of Qwen2-7B's widths (SERVE_LAYERS of 28 layers,
    GQA group 7), whose ragged attention takes a KV head's 7 query heads
    in one block. The launch counts are
    zeroed just before each recipe's requests and read just after; returns
    the Llama run's sums. `grammar_then(recipe)`: the grammar leg's ragged
    wave on each Llama recipe's weights, after its checks."""
    total = _serve_ragged_model(CFG_8B_CUT, "phase6", smi,
                                then=grammar_then)
    _serve_ragged_model(CFG_QWEN2_7B_CUT, "phase6 qwen2-7b", smi)
    return total


# ------------------------------------------------------------ the grammar leg

# the device grammar tables' rows (EngineConfig.grammar_table_states)
GRAMMAR_CAP = 256
GRAMMAR_EOS = "<|eot_id|>"
# a wave of four streams at full width: two table-backed tool calls
# (greedy, seeded-sampled), the generic JSON grammar (its automaton
# overflows the tables: host-only, the block path; 16 tokens, so the
# table-backed streams ride the fused loop once it is done) and a free
# stream. (label, prompt length, grammar, sampling, max_tokens)
GRAMMAR_WAVE = [
    ("tool greedy", 40, "tool", dict(temperature=0.0), NEW_TOKENS),
    ("tool sampled", 300, "tool", dict(temperature=0.8, seed=11),
     NEW_TOKENS),
    ("json host-only", 17, "json", dict(temperature=0.0), 16),
    ("free", 120, "", dict(temperature=0.0), NEW_TOKENS),
]
GRAMMARS = {"tool": TOOL_GBNF, "json": JSON_GBNF, "": ""}
BAD_GBNF = 'root ::= ("a"'
def wave_grammar(g, mode):
    """The GBNF of a stream on grammar `g` in a wave of `mode`, each mode
    over GRAMMAR_WAVE's prompts and budgets: "grammar" as it stands;
    "tables", the JSON stream served free (the device tables' lane alone);
    "free", every stream free (the baseline tok/s)."""
    if mode == "grammar" or (mode == "tables" and g == "tool"):
        return GRAMMARS[g]
    return ""


def _byte_alphabet() -> dict:
    """GPT-2's byte → character map, in which ByteLevel tokenizers spell
    their vocabularies (a space is 'Ġ')."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD))
          + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


def write_tokenizer(d, vocab_size, seed=7):
    """A ByteLevel BPE tokenizer of `vocab_size` entries into `d`
    (tokenizer.json, tokenizer_config.json): the 256 byte symbols, then
    distinct strings of 2-8 JSON-ish characters drawn from a seed, each
    spelled in the byte alphabet, no merges, and the EOS token last."""
    import random
    import string

    byte = _byte_alphabet()
    chars = string.ascii_letters + string.digits + ' {}[]":,_-.'
    rng = random.Random(seed)
    vocab = {byte[b]: b for b in range(256)}
    while len(vocab) < vocab_size - 1:
        w = "".join(rng.choice(chars) for _ in range(rng.randint(2, 8)))
        vocab.setdefault("".join(byte[c] for c in w.encode()), len(vocab))
    level = {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": True, "use_regex": True}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": vocab_size - 1, "content": GRAMMAR_EOS,
                          "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False,
                          "special": True}],
        "normalizer": None, "pre_tokenizer": level, "post_processor": None,
        "decoder": level,
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "vocab": vocab, "merges": []}}
    with open(os.path.join(d, "tokenizer.json"), "w") as f:
        json.dump(spec, f)
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"eos_token": GRAMMAR_EOS, "bos_token": None,
                   "add_bos_token": False}, f)


def grammar_checkpoint(d, cfg_json):
    """A synthetic checkpoint of `cfg_json`'s widths with the tokenizer of
    write_tokenizer, in a directory of its own (a tokenizer turns on the
    EOS checks, which the other phases' checkpoints keep off)."""
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(dict(cfg_json, localai_synthetic=True), f)
    write_tokenizer(d, cfg_json["vocab_size"])


def _grammar_rows(engine, gbnf, toks):
    """[len(toks), V] bool on the engine's device: the allowed set before
    each served token, by a fresh matcher of the port (EOS allowed once
    the grammar is complete)."""
    import numpy as np
    import torch

    m = engine._compile_grammar(gbnf).state()
    eos = sorted(engine.tok.eos_ids)
    V = engine.cfg.vocab_size
    rows = []
    for t in toks:
        rows.append(np.unpackbits(m.mask_bits(eos), bitorder="little")[:V])
        if t in eos:
            break
        m.accept(t)
    return torch.from_numpy(np.stack(rows).astype(bool)).to(engine.device)


def conformant(tok, matcher, toks) -> bool:
    """Every served token up to EOS is accepted by the matcher."""
    for t in toks:
        if t in tok.eos_ids:
            return True
        if not matcher.accept(t):
            return False
    return True


def _stream_rate(times):
    """A stream's decode rate: tokens after the first over the time from
    the first to the last."""
    if len(times) < 2 or times[-1] <= times[0]:
        return None
    return (len(times) - 1) / (times[-1] - times[0])


def grammar_wave_checks(label, engine, results, m0, m1, key_replays, path,
                        mode):
    """A wave's checks and readings: every stream finished; each grammar
    stream conformant up to EOS or its budget; with grammars, the
    table-backed streams' segments replayed as grammar graphs; in a
    "grammar" wave, the host-only stream took the block path."""
    from localai_tpu_torch.functions.matcher import GrammarCache

    cache = GrammarCache(engine.tok)
    out = {"mode": mode, "streams": {}}
    for (name, _, g, _, n), r in zip(GRAMMAR_WAVE, results):
        toks, reason = r["toks"], r["finish"]
        ok = True
        gbnf = wave_grammar(g, mode)
        if gbnf:
            ok = conformant(engine.tok, cache.get(gbnf).state(), toks)
        out["streams"][name] = {
            "tokens": len(toks), "finish": reason, "conformant": ok,
            "tok_s": _stream_rate(r["times"])}
        if not ok:
            raise AssertionError(f"{label} {name}: a served token the "
                                 f"grammar rejects: {toks}")
        if not toks or reason not in ("length", "eos", "stop"):
            raise AssertionError(f"{label} {name}: finish {reason!r} after "
                                 f"{len(toks)} tokens")
        if reason == "length" and len(toks) != n:
            raise AssertionError(f"{label} {name}: {len(toks)} tokens")
        if gbnf and g == "json":
            # the host-only slot's mask walks, replayed over its tokens:
            # the engine walks the vocabulary at admission and after each
            # token the matcher accepts
            m, eos = cache.get(gbnf).state(), sorted(engine.tok.eos_ids)
            walks = []
            for t in [None] + toks:
                if t is not None and (t in eos or not m.accept(t)):
                    break
                t0 = time.perf_counter()
                m.mask_bits(eos)
                walks.append((time.perf_counter() - t0) * 1e3)
            out["hostonly_mask_walks"] = {
                "n": len(walks), "total_ms": sum(walks), "max_ms": max(walks)}

    def gained(k):
        return m1[k] - m0[k]

    grammar_replays = sum(v for k, v in key_replays.items()
                          if k[0] == path and k[3])
    out.update(
        grammar_key_replays=grammar_replays,
        grammar_rollbacks=gained("grammar_rollbacks"),
        grammar_table_overflows=m1["grammar_table_overflows"],
        grammar_table_states=m1["grammar_table_states"],
        block_path_tokens=gained("tokens_by_path__dense"),
        decode_dispatches=gained("decode_dispatches"),
        decode_steps=gained("decode_steps_dispatched"),
        extend_chunks=gained("prefill_chunks_final"))
    if mode != "free" and grammar_replays <= 0:
        raise AssertionError(f"{label}: no {path} graph replay of the "
                             f"grammar key")
    if mode == "grammar" and (out["grammar_table_overflows"] < 1
                              or out["block_path_tokens"] <= 0):
        raise AssertionError(f"{label}: the host-only stream did not take "
                             f"the block path")
    return out


def _wave_prompt(i, n):
    return prompt_ids(40 + i, n, salt=17)


def grammar_reference(label, engine, results, phase):
    """The greedy table-backed stream against the teacher-forced
    reference, its rows masked by the grammar; the fault: the same tokens
    after a wrong prompt."""
    r = results[0]
    g = GRAMMARS[GRAMMAR_WAVE[0][2]]
    cases = {"tool greedy": (r["ids"], r["toks"], r["lps"])}
    fault = (prompt_ids(99, len(r["ids"]), salt=99), r["toks"], r["lps"])
    return check_reference(label, engine, cases, fault, phase=phase,
                           grammar=g)


def serve_grammar_grpc(name, model_dir, load_kw, smi):
    """The grammar wave through the port's gRPC backend on the dense path
    (loaded with the tokenizer's checkpoint), a malformed GBNF sent
    mid-wave (INVALID_ARGUMENT), then a wave of four free streams with
    the same prompts and budgets (the baseline tok/s, same call)."""
    import threading

    import grpc
    import torch

    from localai_tpu_torch.backend.server import serve

    server, servicer, port = serve("127.0.0.1:0", device="cuda")
    client = _Client(f"127.0.0.1:{port}")
    label = f"phase7 grammar dense {name}"
    try:
        t0 = time.perf_counter()
        r = client.load(model=model_dir, parallel=4, context_size=2048,
                        **load_kw)
        if not r.success:
            raise RuntimeError(f"{label}: LoadModel failed: {r.message}")
        log(f"{label}: LoadModel (weights + warmup) "
            f"{time.perf_counter() - t0:.1f} s")
        eng = servicer.engine

        def wave(mode):
            results = [None] * len(GRAMMAR_WAVE)

            def one(i, n, g, sp, budget):
                ids = _wave_prompt(i, n)
                rec = dict(ids=ids, toks=[], lps=[], times=[], finish=None)
                gbnf = wave_grammar(g, mode)
                for c in client.stream(
                        prompt_ids=ids, tokens=budget, logprobs=True,
                        grammar=gbnf, ignore_eos=not gbnf, **sp):
                    now = time.perf_counter()
                    rec["toks"] += list(c.token_ids)
                    rec["lps"] += list(c.logprobs)
                    rec["times"] += [now] * len(c.token_ids)
                    rec["finish"] = c.finish_reason or rec["finish"]
                results[i] = rec

            threads = [threading.Thread(target=one, args=(i, n, g, sp, b))
                       for i, (_, n, g, sp, b) in enumerate(GRAMMAR_WAVE)]
            ts = time.perf_counter()
            for t in threads:
                t.start()
            bad = None
            if mode == "grammar":
                try:
                    list(client.stream(prompt_ids=[1, 2, 3], tokens=8,
                                       grammar=BAD_GBNF))
                except grpc.RpcError as e:
                    bad = e.code()
            for t in threads:
                t.join()
            wall = time.perf_counter() - ts
            if any(r is None for r in results):
                raise RuntimeError(f"{label}: a stream failed")
            return results, wall, bad

        outs = {}
        # the grammar wave twice: cold (each grammar's first request:
        # its automaton enumerated at submit) and warm
        for kind, mode in (("cold", "grammar"), ("warm", "grammar"),
                           ("tables", "tables"), ("free", "free")):
            m0, k0 = client.metrics(), eng.graphs.key_replays()
            res, wall, bad = wave(mode)
            m1, k1 = client.metrics(), eng.graphs.key_replays()
            if mode == "grammar" and bad != grpc.StatusCode.INVALID_ARGUMENT:
                raise AssertionError(f"{label}: a malformed GBNF gave {bad}")
            out = outs[kind] = grammar_wave_checks(
                f"{label} {kind}", eng, res, m0, m1,
                {k: v - k0.get(k, 0) for k, v in k1.items()}, "dense", mode)
            toks = sum(len(r["toks"]) for r in res)
            out.update(wave_tokens=toks, wave_s=wall, wave_tok_s=toks / wall,
                       table_bytes=eng._gmasks.nbytes + eng._gtrans.nbytes,
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
                       card=smi)
            if mode == "grammar":
                out["malformed_gbnf"] = "INVALID_ARGUMENT"
                results = res
            log(f"{label} {kind} wave " + json.dumps(out))
        grammar_reference(name, eng, results, "phase7 grammar dense")
        return outs
    finally:
        client.close()
        servicer.shutdown()
        server.stop(grace=1).wait(10)
        servicer.engine = None
        import gc

        gc.collect()
        torch.cuda.empty_cache()


def grammar_engine_wave(eng, mode):
    """A wave of `mode` (wave_grammar) through an in-process Engine.
    Returns (per-stream records, wall seconds)."""
    from localai_tpu_torch.engine.engine import GenRequest
    from localai_tpu_torch.ops.sampling import SamplingParams

    recs = []
    t0 = time.perf_counter()
    for i, (_, n, g, sp, budget) in enumerate(GRAMMAR_WAVE):
        ids = _wave_prompt(i, n)
        gbnf = wave_grammar(g, mode)
        _, q = eng.submit(GenRequest(
            ids, SamplingParams(**sp), max_tokens=budget, logprobs=True,
            grammar=gbnf, ignore_eos=not gbnf))
        recs.append(dict(ids=ids, q=q, toks=[], lps=[], times=[],
                         finish=None))
    for _ in range(100000):
        busy = eng.step()
        now = time.perf_counter()
        for r in recs:
            while not r["q"].empty():
                o = r["q"].get_nowait()
                if o.token_id >= 0:
                    r["toks"].append(o.token_id)
                    r["lps"].append(o.logprob)
                    r["times"].append(now)
                if o.finished:
                    r["finish"] = o.finish_reason
        if not busy:
            break
    return recs, time.perf_counter() - t0


@contextlib.contextmanager
def host_seconds(eng, acc):
    """Within: the host seconds (inclusive; nested calls count in each)
    the engine spends in each of its grammar-relevant methods, and in the
    matcher's mask walks, summed into `acc`. Only the smoke's reading: the
    engine's own code is unchanged."""
    from localai_tpu_torch.functions.matcher import MatcherState

    def timed(key, f):
        def w(*a, **k):
            t0 = time.perf_counter()
            try:
                return f(*a, **k)
            finally:
                acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
        return w

    names = ("step", "_dispatch", "_consume", "_emit", "_repair",
             "_prefill_tick", "_ragged_tick", "_dev_decode_block",
             "_dev_decode", "_dev_rloop_decode", "_dev_ragged_loop")
    for n in names:
        setattr(eng, n, timed(n, getattr(eng, n)))
    walk = MatcherState.mask_bits
    MatcherState.mask_bits = timed("mask_walk", walk)
    try:
        yield acc
    finally:
        MatcherState.mask_bits = walk
        for n in names:
            delattr(eng, n)


def grammar_ragged(name, smi, tok):
    """serve_ragged's `then`: the grammar wave on a ragged Engine of phase
    6's shape over the same weights, with the grammar checkpoint's
    tokenizer; a malformed GBNF rejected at submit; then the free wave."""
    import torch

    from localai_tpu_torch.engine.engine import (
        Engine, EngineConfig, GenRequest,
    )

    def then(eng0):
        label = f"phase7 grammar ragged {name}"
        t0 = time.perf_counter()
        eng = Engine(eng0.cfg, eng0.params, tok, EngineConfig(
            **RAGGED_EC, cache_type=eng0.ec.cache_type), device="cuda")
        eng.warmup()
        log(f"{label}: engine + warmup {time.perf_counter() - t0:.1f} s")
        try:
            eng.submit(GenRequest([1, 2], grammar=BAD_GBNF))
        except ValueError:
            pass
        else:
            raise AssertionError(f"{label}: a malformed GBNF was accepted")
        for kind, mode in (("cold", "grammar"), ("warm", "grammar"),
                           ("tables", "tables"), ("free", "free")):
            m0, k0 = dict(eng.metrics), eng.graphs.key_replays()
            with host_seconds(eng, {}) as host:
                res, wall = grammar_engine_wave(eng, mode)
            m1, k1 = dict(eng.metrics), eng.graphs.key_replays()
            out = grammar_wave_checks(
                f"{label} {kind}", eng, res, m0, m1,
                {k: v - k0.get(k, 0) for k, v in k1.items()}, "rloop", mode)
            out["host_s"] = host
            out["host_sync_wait_s"] = (m1["host_sync_wait_ms"]
                                       - m0["host_sync_wait_ms"]) / 1e3
            toks = sum(len(r["toks"]) for r in res)
            out.update(
                wave_tokens=toks, wave_s=wall, wave_tok_s=toks / wall,
                ragged_dispatches=m1["ragged_dispatches"]
                - m0["ragged_dispatches"],
                table_bytes=eng._gmasks.nbytes + eng._gtrans.nbytes,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
                card=smi)
            if mode == "grammar":
                out["malformed_gbnf"] = "ValueError at submit"
                results = res
            log(f"{label} {kind} wave " + json.dumps(out))
        grammar_reference(name, eng, results, "phase7 grammar ragged")
        del eng
    return then


def phase_grammar_tables(smi, tok):
    """The grammar tables at V = 128256: the build's seconds and states
    for the tool-call grammar, the JSON grammar's overflow, and the bytes
    of the device tables an engine allocates."""
    from localai_tpu_torch.functions.matcher import CompiledGrammar, \
        token_texts

    t0 = time.perf_counter()
    texts = token_texts(tok)
    t1 = time.perf_counter()
    out = {"vocab": len(texts), "token_texts_s": t1 - t0, "cap": GRAMMAR_CAP}
    for g in ("tool", "json"):
        t0 = time.perf_counter()
        cg = CompiledGrammar(GRAMMARS[g], texts)
        tbl = cg.table(GRAMMAR_CAP)
        t1 = time.perf_counter()
        # a host-only slot's per-token cost: the matcher's mask walk (a
        # trial of every vocabulary entry) at the start state
        cg.state().mask_bits(sorted(tok.eos_ids))
        out[g] = {"build_s": t1 - t0,
                  "states": None if tbl is None else tbl.n_states,
                  "mask_bits_ms": (time.perf_counter() - t1) * 1e3}
    V = len(texts)
    out["table_bytes"] = GRAMMAR_CAP * (4 * ((V + 31) // 32) + 4 * V)
    out["card"] = smi
    log("phase7 grammar tables " + json.dumps(out))
    if out["tool"]["states"] is None or out["json"]["states"] is not None:
        raise AssertionError("phase7: the tool grammar must fit the tables "
                             "and the JSON grammar overflow them")
    return out


# phase 3's grammar engines: dense, paged and ragged, four slots
GRAMMAR_CVC_EC = dict(max_slots=4, max_context=512, prefill_buckets=(32,),
                      prefill_chunk=32)


def grammar_serve(cfg, model, tok, device, ec, n_req=2, eager=False):
    """Phase 3's grammar requests — a table-backed tool-call one, greedy
    and seeded-sampled, then a free one — the first `n_req` of them, 24
    tokens each, on an Engine of `ec` over `model` moved to `device`
    (`eager`: EagerSegments for the graphs). Returns ([(tokens, logprobs)],
    the engine)."""
    from localai_tpu_torch.engine.engine import (
        Engine, EngineConfig, GenRequest,
    )
    from localai_tpu_torch.engine.graphs import EagerSegments
    from localai_tpu_torch.ops.sampling import SamplingParams

    reqs = [(prompt_ids(1, 23), dict(temperature=0.0), TOOL_GBNF),
            (prompt_ids(2, 31), dict(temperature=0.8, seed=7), TOOL_GBNF),
            (prompt_ids(3, 19), dict(temperature=0.0), "")]
    eng = Engine(cfg, model.to(device), tok, EngineConfig(**ec),
                 device=device)
    if eager:
        eng.graphs = EagerSegments(eng.device)
    eng.warmup()
    qs = [eng.submit(GenRequest(ids, SamplingParams(**sp),
                                max_tokens=24, grammar=g,
                                ignore_eos=not g, logprobs=True))[1]
          for ids, sp, g in reqs[:n_req]]
    while eng.step():
        pass
    out = []
    for q in qs:
        toks, lps = [], []
        while not q.empty():
            o = q.get_nowait()
            if o.token_id >= 0:
                toks.append(o.token_id)
                lps.append(o.logprob)
        out.append((toks, lps))
    return out, eng


def phase_grammar_card_vs_cpu(tok, cs):
    """Phase 3's grammar checks: the 2-layer f32 model at the 8B widths
    (V = 128256; phase3_model) with the grammar checkpoint's tokenizer. A
    table-backed tool-call request, greedy and seeded-sampled: the same
    tokens on the card as on the CPU (phase3_cpu_side's run), and as the
    host-masked path on the card; on the dense, paged and ragged engines
    graph replays of the grammar variant equal eager segments bit for
    bit."""
    import torch

    from localai_tpu_torch.functions.matcher import GrammarCache

    cfg, model, base = cs["cfg"], cs["model"], GRAMMAR_CVC_EC
    ecs = {"dense": base, "paged": dict(base, kv_pages=9),
           "rloop": dict(base, kv_pages=9, ragged_token_budget=64)}

    def serve(ec, **kw):
        return grammar_serve(cfg, model, tok, "cuda", ec, **kw)

    cpu = cs["grammar_cpu"]
    card, eng = serve(base)
    hostonly, _ = serve(dict(base, grammar_table_states=0, decode_block=1,
                             decode_loop=0))
    cache = GrammarCache(tok)
    res = {"cpu_s": cs["grammar_cpu_s"],
           "cpu_tokens": [t for t, _ in cpu], "card_tokens": [t for t, _ in
                                                               card],
           "card_hostonly_tokens": [t for t, _ in hostonly],
           "conformant": [conformant(tok, cache.get(TOOL_GBNF).state(), t)
                          for t, _ in card],
           "dense_grammar_replays": sum(
               v for k, v in eng.graphs.key_replays().items() if k[3])}
    log("phase3 grammar " + json.dumps(res))
    if res["cpu_tokens"] != res["card_tokens"]:
        raise AssertionError("phase3 grammar: card and CPU tokens differ")
    if res["card_hostonly_tokens"] != res["card_tokens"]:
        raise AssertionError("phase3 grammar: the table-backed and the "
                             "host-masked paths' tokens differ")
    if not all(res["conformant"]) or not res["dense_grammar_replays"]:
        raise AssertionError("phase3 grammar: a token the grammar rejects, "
                             "or no grammar graph replayed")
    for path, ec in ecs.items():
        graphed, geng = serve(ec, n_req=3)
        eager, _ = serve(ec, n_req=3, eager=True)
        reps = sum(v for k, v in geng.graphs.key_replays().items()
                   if k[0] == path and k[3])
        r = {"equal": [g == e for g, e in zip(graphed, eager)],
             "tokens": [len(t) for t, _ in graphed],
             "grammar_replays": reps}
        log(f"phase3 grammar graphs {path} " + json.dumps(r))
        if not all(r["equal"]) or reps <= 0:
            raise AssertionError(f"phase3 grammar graphs {path}: replays "
                                 f"and eager segments differ, or no "
                                 f"grammar graph replayed")
        del geng
    del eng
    cs.clear()
    torch.cuda.empty_cache()


def grammar_setup(d):
    """The grammar leg's checkpoint in `d`: the synthetic Llama-3.1-8B's
    config and write_tokenizer's tokenizer of its vocabulary. Returns the
    port's Tokenizer of it."""
    from localai_tpu_torch.engine.tokenizer import Tokenizer

    t0 = time.perf_counter()
    grammar_checkpoint(d, CFG_8B_CUT)
    tok = Tokenizer.from_dir(d)
    log(f"grammar checkpoint: a tokenizer of {tok.vocab_size} entries "
        f"written and loaded in {time.perf_counter() - t0:.1f} s; EOS "
        f"{sorted(tok.eos_ids)}")
    return tok


def phase_grammar(d, smi, tok):
    """Phase 7, the grammar leg at full width: the tables at V = 128256,
    then the synthetic Llama-3.1-8B (SERVE_LAYERS of its 32 layers) with
    the grammar
    checkpoint's tokenizer served by the gRPC backend on the dense path,
    bf16 then the int8 recipe. (The ragged path's grammar wave ran on
    phase 6's weights: grammar_ragged.)"""
    os.environ["LOCALAI_ALLOW_SYNTHETIC"] = "1"
    tables = phase_grammar_tables(smi, tok)
    out = {name: serve_grammar_grpc(name, d, kw, smi)
           for name, kw in (("bf16", dict(dtype="bfloat16")),
                            ("int8", dict(dtype="int8",
                                          cache_type_key="int8",
                                          cache_type_value="int8")))}
    return tables, out


# ------------------------------------------------------------------ phase 8

# the draft-free runs' readings (phase 4's dense and phase 6's ragged run,
# phase 8's paged one), by (path, recipe): phase 8's "without the draft"
PLAIN = {}
RECIPES = (("bf16", "bfloat16", ""), ("int8", "int8", "int8"))
# phase 4's four prompts, the fourth greedy: three greedy streams for the
# teacher-forced check
SPEC_REQUESTS = [(1, dict(temperature=0.0)),
                 (17, dict(temperature=0.8, top_k=40, seed=11)),
                 (300, dict(temperature=0.0)),
                 (700, dict(temperature=0.0))]
# phase 5's pool, served in-process; phase 6's ragged engine (a draft
# engine never runs the fused ragged loop, so ragged_loop_steps is unread)
SPEC_PAGED_EC = dict(max_slots=8, max_context=4096, kv_pages=129,
                     prefill_buckets=(64, 256, 512), prefill_chunk=512)
# phase 8's target at SERVE_LAYERS (4) of the 8B's 32 layers and its draft
# at 2 of the 1B's 16, to keep the whole smoke within its time limit; the
# spec checks count launches by these
SPEC_TARGET = CFG_8B_CUT
SPEC_DRAFT = dict(CFG_1B, num_hidden_layers=2)
LAYERS_8B = SPEC_TARGET["num_hidden_layers"]
DRAFT_LAYERS = SPEC_DRAFT["num_hidden_layers"]


def draft_fault(engine, ids, toks, lps):
    """The planted fault of the spec legs: an accept test that takes every
    draft. Its stream is the draft's own greedy proposal at each position
    (the draft's plain forward over the prompt and the served tokens, the
    weight GEMMs' plain versions), which the teacher-forced check must
    reject."""
    import torch

    from localai_tpu_torch.models.llama import extend, init_kv_cache

    dcfg, dparams = engine._draft
    dev = engine.device
    seq = list(ids) + list(toks[:-1])
    kc, vc = init_kv_cache(dcfg, 1, len(seq), engine._kv_dtype, device=dev)
    with torch.no_grad(), plain_weight_gemms():
        logits = extend(dparams, dcfg,
                        torch.tensor([seq], dtype=torch.int32, device=dev),
                        torch.zeros((1,), dtype=torch.int32, device=dev),
                        engine._cos_d, engine._sin_d, kc, vc)
    fake = logits[0, len(ids) - 1:].argmax(-1).tolist()
    return ids, fake, lps


def spec_split(engine, label, smi, reps=3):
    """A spec dispatch of four active slots (kv lengths 33, 49, 332, 732;
    two greedy, two sampled) on `engine`'s weights and fresh caches, in its
    three parts: the draft's gamma decode steps and the ingest of the last
    draft, the target's verify forward, and the accept tail (the target
    distributions, the accept test, the correction draw and the commit).
    Per part: the host's ms to enqueue it, its wall ms to a synchronize,
    and the card's busy ms (torch.profiler, the kernels' device time);
    medians of `reps`."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from localai_tpu_torch.engine import spec as sp
    from localai_tpu_torch.models.llama import extend, init_kv_cache
    from localai_tpu_torch.ops.sampling import SamplerState, split_keys

    cfg, (dcfg, dparams) = engine.cfg, engine._draft
    B, T, G, dev = 4, engine.ec.max_context, engine.ec.gamma, "cuda"
    kt, vt = init_kv_cache(cfg, B, T, engine._kv_dtype,
                           cache_type=engine.ec.cache_type, device=dev)
    kd, vd = init_kv_cache(dcfg, B, T, engine._kv_dtype, device=dev)
    lengths = torch.tensor([33, 49, 332, 732], dtype=torch.int32,
                           device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    nxt = torch.tensor([11, 12, 13, 14], dtype=torch.int32, device=dev)
    sampler = SamplerState.init(B, cfg.vocab_size, device=dev)
    sampler.greedy[:2] = True
    sampler.key[:, 1] = torch.arange(B, device=dev) + 1
    st = {}

    def draft():
        st["carry"], st["step"] = split_keys(sampler.key)
        st["d"], st["pd"] = sp._draft_phase(
            dparams, dcfg, G, engine._cos_d, engine._sin_d, kd, vd, sampler,
            lengths, nxt, active, st["step"])

    def verify():
        window = torch.cat([nxt[:, None], st["d"]], dim=1)
        st["tl"] = extend(engine.params, cfg, window, lengths, engine._cos,
                          engine._sin, kt, vt)

    def accept():
        sp._verify_outputs(sampler, active, st["step"], st["carry"],
                           st["d"], st["pd"], st["tl"], G)

    parts = (("draft", draft), ("verify", verify), ("accept", accept))
    times = {k: {"host_ms": [], "wall_ms": [], "busy_ms": []}
             for k, _ in parts}
    with torch.no_grad():
        for _ in range(reps + 1):            # the first round warms up
            for k, fn in parts:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                times[k]["host_ms"].append((t1 - t0) * 1e3)
                times[k]["wall_ms"].append((t2 - t0) * 1e3)
        for _ in range(reps):
            for k, fn in parts:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as p:
                    fn()
                    torch.cuda.synchronize()
                busy = sum(e.self_device_time_total
                           for e in p.key_averages()) / 1e3
                times[k]["busy_ms"].append(busy)
    out = {}
    for k, r in times.items():
        out[k] = {m: statistics.median(v[-reps:]) if v else None
                  for m, v in r.items()}
        if not out[k]["busy_ms"]:
            out[k]["busy_ms"] = "not measured (the profiler saw no "\
                                "device time)"
    log(f"phase8 {label} spec dispatch split (B=4, gamma={G}) "
        + json.dumps(out) + f" card {smi}")
    del kt, vt, kd, vd
    torch.cuda.empty_cache()
    return out


def _spec_summary(label, m0, m1, spec, plain, smi, extra=None):
    """The with/without-draft line of one leg."""
    proposed = m1["draft_proposed"] - m0["draft_proposed"]
    accepted = m1["draft_accepted"] - m0["draft_accepted"]
    row = {"with_draft": {"tok_s": spec["tok_s"],
                          "ttft_p50_ms": spec["ttft_p50_ms"]},
           "without_draft": None if plain is None else {
               "tok_s": plain["tok_s"], "ttft_p50_ms": plain["ttft_p50_ms"]},
           "draft_proposed": proposed, "draft_accepted": accepted,
           "acceptance": accepted / max(proposed, 1),
           "acceptance_note": "random weights: the draft and the target "
                              "agree by chance only; not a finding about "
                              "the port",
           **(extra or {})}
    log(f"phase8 {label} " + json.dumps(row) + f" card {smi}")
    return row


def _spec_launch_checks(label, counts, m0, m1, ragged):
    """Row 2 launched (gamma+1) x DRAFT_LAYERS times a spec dispatch (the
    draft's steps), counted from the engine's metrics; on the ragged path rows
    8-11 once a layer a spec-as-ragged dispatch; the target never ran the
    decode kernels, and no fused loop ran."""
    G = SPEC_GAMMA

    def gained(k):
        return int(m1[k] - m0[k])

    if ragged:
        n = gained("spec_ragged_dispatches")
        if n <= 0 or n != gained("ragged_dispatches"):
            raise AssertionError(f"phase8 {label}: {n} spec-as-ragged "
                                 f"dispatches of "
                                 f"{gained('ragged_dispatches')} ragged")
        steps = (G + 1) * n
    else:
        n = gained("decode_dispatches")
        steps = gained("decode_steps_dispatched")
        if n <= 0 or steps != (G + 1) * n:
            raise AssertionError(f"phase8 {label}: {steps} steps in {n} "
                                 f"spec dispatches")
    want = {"ragged_decode": DRAFT_LAYERS * steps}
    zero = ["ragged_decode_q8", "ragged_decode_paged",
            "ragged_decode_q8_paged", "paged_scatter_append",
            "paged_scatter_append_q8"]
    if ragged:
        q8 = counts["ragged_paged_attention_q8"] > 0
        sfx = "_q8" if q8 else ""
        want["ragged_paged_attention" + sfx] = LAYERS_8B * n
        want["ragged_scatter_append" + sfx] = LAYERS_8B * n
        zero += ["flash_prefill",
                 "ragged_paged_attention" + ("" if q8 else "_q8"),
                 "ragged_scatter_append" + ("" if q8 else "_q8")]
    for k, v in want.items():
        if counts[k] != v:
            raise AssertionError(f"phase8 {label}: {k} launched "
                                 f"{counts[k]} times, not {v} ({n} spec "
                                 f"dispatches, gamma {G})")
    for k in zero:
        if counts[k]:
            raise AssertionError(f"phase8 {label}: {k} launched on the "
                                 f"spec path")
    for k in ("tokens_by_path__loop", "tokens_by_path__rloop"):
        if gained(k):
            raise AssertionError(f"phase8 {label}: a fused loop ran")
    return {"spec_dispatches": n, **{k: counts[k] for k in want}}


def spec_dense(name, d, dd, dtype, kv, smi):
    """The dense path through the gRPC backend:
    LoadModel(draft_model, n_draft=4), phase 4's prompts."""
    from localai_tpu_torch.ops.kernels import reset_launch_counts

    kw = dict(dtype=dtype, draft_model=dd, n_draft=SPEC_GAMMA)
    if kv:
        kw.update(cache_type_key=kv, cache_type_value=kv)
    res = {}

    def then(client, servicer, out):
        eng = servicer.engine
        if eng.ec.gamma != SPEC_GAMMA or eng._draft is None:
            raise AssertionError("phase8: LoadModel did not make a draft "
                                 "engine of n_draft")
        m0, m1 = out["metrics_before"], out["metrics_after"]
        res["launches"] = _spec_launch_checks(
            f"dense {name}", out["launches_during_requests"], m0, m1, False)
        results = out["_results"]
        cases = {f"{len(results[i][4])}-token": (results[i][4],
                                                 results[i][1],
                                                 results[i][2])
                 for i in (0, 2, 3)}
        fault = draft_fault(eng, *cases["700-token"])
        check_reference(name, eng, cases, fault, phase="phase8 dense")
        res["summary"] = _spec_summary(
            f"dense {name}", m0, m1, out, PLAIN.get(("dense", name)), smi,
            extra={"launches": res["launches"],
                   "without_draft_note": "phase 4's run, at 32 layers "
                                         f"(the target: {LAYERS_8B}): the "
                                         "same prompts, its fourth "
                                         "request sampled"})
        res["split"] = spec_split(eng, f"dense {name}", smi)

    # LoadModel's prewarm serves three 50-token requests, which on the
    # eager spec path take longer than the wave; the kernels are built and
    # nothing is compiled at a first use, so the leg loads without it
    os.environ["LOCALAI_NO_PREWARM"] = "1"
    try:
        reset_launch_counts()
        res["out"] = serve_recipe(name, d, kw, phase="phase8 dense",
                                  waves=[SPEC_REQUESTS], then=then)
    finally:
        del os.environ["LOCALAI_NO_PREWARM"]
    return res


def spec_engine(name, d, dd, dtype, kv, ec, path, smi, plain=False):
    """A draft Engine in-process on the paged pool or the ragged path,
    phase 6's two waves of four requests; with `plain`, the same requests
    first through the same engine configuration without the draft."""
    import gc
    import statistics

    import torch

    from localai_tpu_torch.engine.engine import Engine, EngineConfig
    from localai_tpu_torch.engine.loader import load_config, load_params
    from localai_tpu_torch.ops.kernels import launch_counts, \
        reset_launch_counts

    cfg = load_config(d, dtype=dtype)
    params = load_params(d, cfg, dtype=dtype, device="cuda")
    dcfg = load_config(dd, dtype=dtype)
    dparams = load_params(dd, dcfg, dtype=dtype, device="cuda")
    label = f"{path} {name}"

    def run(draft):
        t0 = time.perf_counter()
        eng = Engine(cfg, params, None, EngineConfig(
            **ec, cache_type=kv, gamma=SPEC_GAMMA), draft=draft,
            device="cuda")
        eng.warmup()
        setup = time.perf_counter() - t0
        reset_launch_counts()
        m0 = dict(eng.metrics)
        recs, wall = drive_engine(eng)
        torch.cuda.synchronize()
        counts = launch_counts()
        m1 = dict(eng.metrics)
        for i, r in enumerate(recs):
            last = r["last"]
            if (last is None or last.finish_reason != "length"
                    or len(r["toks"]) != NEW_TOKENS
                    or not all(0 <= t < cfg.vocab_size for t in r["toks"])):
                raise AssertionError(f"phase8 {label} request {i}: finish "
                                     f"{last and last.finish_reason} "
                                     f"tokens {len(r['toks'])}")
        ttfts = [r["ttft"] for r in recs]
        gen = m1["tokens_generated"] - m0["tokens_generated"]
        stats = {"tok_s": gen / wall, "ttft_p50_ms":
                 statistics.median(ttfts) * 1e3, "wall_s": wall,
                 "tokens": gen, "setup_s": setup,
                 "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
        return eng, recs, counts, m0, m1, stats

    try:
        if plain:
            eng, _, _, _, _, PLAIN[path, name] = run(None)
            del eng
            gc.collect()
        torch.cuda.reset_peak_memory_stats()
        eng, recs, counts, m0, m1, stats = run((dcfg, dparams))
        launches = _spec_launch_checks(label, counts, m0, m1,
                                       path == "ragged")
        if path == "ragged":
            prompts = sum(len(r["ids"]) for r in recs)
            got = m1["ragged_prefill_tokens"] - m0["ragged_prefill_tokens"]
            if got != prompts:
                raise AssertionError(f"phase8 {label}: {got} prefill rows "
                                     f"packed for {prompts} prompt tokens")
        cases = {f"{len(r['ids'])}-token": (r["ids"], r["toks"], r["lps"])
                 for r in (recs[2], recs[4], recs[5])}
        fault = draft_fault(eng, *cases["1500-token"])
        check_reference(name, eng, cases, fault, phase=f"phase8 {path}")
        summary = _spec_summary(
            label, m0, m1, stats, PLAIN.get((path, name)), smi,
            extra={"launches": launches, "setup_s": stats["setup_s"],
                   "peak_mem_gb": stats["peak_mem_gb"],
                   "without_draft_note": (
                       "the same requests without the draft, just before"
                       if plain else "phase 6's run of the same requests")})
        return {"summary": summary, "counts": counts}
    finally:
        eng = None
        del params, dparams
        gc.collect()
        torch.cuda.empty_cache()


# the perfect-draft leg. In f32 the draft's decode and the verify agree to
# ~1e-6, so a greedy proposal is rejected only at a tie. In bf16 they
# round differently (the decode kernel and GEMMs at M = B beside the
# verify's window at M = B x 5), and with random weights the top two of
# 128256 logits of std 1 lie ~0.2 apart: a few % of greedy argmaxes flip
# between the two, as they do between the served streams and their plain
# teacher-forced reference (argmax_equal 60-64 of 64), and each flip
# rejects the rest of its window. So every rejected proposal must be
# within PERFECT_TIE logit of the plain reference's largest logit at its
# position (a tie, not a fault), and the acceptance at least the floor.
PERFECT_FLOOR = {"float32": 0.95, "bfloat16": 0.85}
PERFECT_TIE = 0.05


def spec_perfect_draft(d, smi):
    """The target as its own draft (2 layers at the 8B widths), bf16 and
    f32, dense and ragged: greedy proposals are accepted (at least
    PERFECT_FLOOR of them), and each rejected one is a tie of the plain
    teacher-forced reference (within PERFECT_TIE of its largest logit)."""
    import gc
    import tempfile

    import torch

    from localai_tpu_torch.engine.loader import load_config, load_params

    out = {}
    for dtype in ("bfloat16", "float32"):
        with tempfile.TemporaryDirectory() as d2:
            with open(os.path.join(d2, "config.json"), "w") as f:
                json.dump(dict(CFG_8B, num_hidden_layers=2,
                               localai_synthetic=True), f)
            cfg = load_config(d2, dtype=dtype)
            params = load_params(d2, cfg, dtype=dtype, device="cuda")
        _perfect_draft_runs(cfg, params, dtype, out)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    log("phase8 perfect draft (2 layers, 8B widths, draft = target) "
        + json.dumps(out) + f" card {smi}")
    for key, r in out.items():
        if r["acceptance"] < r["floor"]:
            raise AssertionError(f"phase8 perfect draft {key}: acceptance "
                                 f"{r['acceptance']} < {r['floor']}")
        if r["rejections"] and r["max_rejected_gap"] > PERFECT_TIE:
            raise AssertionError(f"phase8 perfect draft {key}: a rejected "
                                 f"proposal is no tie of the reference {r}")
    return out


def _perfect_draft_runs(cfg, params, dtype, out):
    """spec_perfect_draft's engines, dense and ragged, on one dtype. The
    draft's proposals (engine/spec.py `_draft_phase`) and each window's
    accepted run (`Engine._emit_windows`) are recorded on the way, so a
    rejected proposal's position is known; the plain reference (the
    target's plain forward over the prompt and the stream before that
    position) gives its gap to the largest logit there."""
    import torch

    from localai_tpu_torch.engine import spec
    from localai_tpu_torch.engine.engine import (
        Engine, EngineConfig, GenRequest,
    )
    from localai_tpu_torch.models.llama import extend, init_kv_cache
    from localai_tpu_torch.ops.sampling import SamplingParams

    G, proposals = SPEC_GAMMA, {}
    draft_phase = spec._draft_phase

    def recording(*a, **kw):
        d, p = draft_phase(*a, **kw)
        proposals["d"] = d.tolist()
        return d, p

    spec._draft_phase = recording
    try:
        for path, ec in (("dense", dict(max_slots=4, max_context=2048,
                                        prefill_buckets=(64, 256, 512),
                                        prefill_chunk=512)),
                         ("ragged", RAGGED_EC)):
            eng = Engine(cfg, params, None, EngineConfig(**ec, gamma=G),
                         draft=(cfg, params), device="cuda")
            rejected = []
            emit = eng._emit_windows

            def windows(entries, toks, n_out, lps, n_extra, eng=eng,
                        emit=emit, rejected=rejected):
                for i, rid in entries:
                    s, k = eng._slots[i], int(n_extra[i])
                    if s is not None and s.request_id == rid and k < G:
                        rejected.append((rid, s.generated + k,
                                         proposals["d"][i][k]))
                emit(entries, toks, n_out, lps, n_extra)

            eng._emit_windows = windows
            reqs = {}
            for i, (n, sp) in enumerate(SPEC_REQUESTS):
                if sp["temperature"] == 0.0:
                    ids = prompt_ids(i, n)
                    rid, q = eng.submit(GenRequest(
                        ids, SamplingParams(**sp), max_tokens=NEW_TOKENS,
                        ignore_eos=True))
                    reqs[rid] = (ids, q, [])
            while eng.step():
                pass
            for ids, q, toks in reqs.values():
                while not q.empty():
                    o = q.get_nowait()
                    if o.token_id >= 0:
                        toks.append(o.token_id)
                if len(toks) != NEW_TOKENS:
                    raise AssertionError(f"phase8 perfect draft {path}: "
                                         f"{len(toks)} tokens")
            gaps = []
            for rid, at, proposed in rejected:
                ids, _, toks = reqs[rid]
                if at >= len(toks):
                    continue                # past the request's budget
                seq, dev = list(ids) + toks[:at], eng.device
                kc, vc = init_kv_cache(cfg, 1, len(seq), device=dev)
                with torch.no_grad(), plain_weight_gemms():
                    ref = extend(params, cfg, torch.tensor(
                        [seq], dtype=torch.int32, device=dev),
                        torch.zeros((1,), dtype=torch.int32, device=dev),
                        eng._cos, eng._sin, kc, vc)[0, -1].float()
                gaps.append(float(ref.max() - ref[proposed]))
            m = eng.metrics
            out[f"{path} {dtype}"] = {
                "draft_proposed": m["draft_proposed"],
                "draft_accepted": m["draft_accepted"],
                "acceptance": m["draft_accepted"]
                / max(m["draft_proposed"], 1),
                "floor": PERFECT_FLOOR[dtype],
                "rejections": len(gaps), "rejected_gaps": gaps,
                "max_rejected_gap": max(gaps, default=0.0),
                "tokens_per_spec_step": m["tokens_by_path__spec"]
                / max(m["draft_proposed"] // G, 1)}
            del eng
    finally:
        spec._draft_phase = draft_phase


def phase_spec_path(smi):
    """Phase 8, speculative decoding at full width: the synthetic
    Llama-3.1-8B (4 of its 32 layers) with a synthetic draft of
    Llama-3.2-1B's widths (2 of its 16 layers), gamma 4, bf16 then the
    int8 recipe, on the dense
    path (the gRPC backend's LoadModel draft_model), the paged pool and
    the ragged path (in-process Engines); then the perfect-draft leg.
    Returns the launch counts of the spec legs' requests, summed."""
    import tempfile

    os.environ["LOCALAI_ALLOW_SYNTHETIC"] = "1"
    total, out = {}, {}
    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as dd:
        for path, cfg_json in ((d, SPEC_TARGET), (dd, SPEC_DRAFT)):
            with open(os.path.join(path, "config.json"), "w") as f:
                json.dump(dict(cfg_json, localai_synthetic=True), f)
        for name, dtype, kv in RECIPES:
            r = spec_dense(name, d, dd, dtype, kv, smi)
            out["dense", name] = r["summary"]
            for k, v in r["out"]["launches_during_requests"].items():
                total[k] = total.get(k, 0) + v
            for path, ec, plain in (("paged", SPEC_PAGED_EC, True),
                                    ("ragged", RAGGED_EC, False)):
                r = spec_engine(name, d, dd, dtype, kv, ec, path, smi,
                                plain=plain)
                out[path, name] = r["summary"]
                for k, v in r["counts"].items():
                    total[k] = total.get(k, 0) + v
        perfect = spec_perfect_draft(d, smi)
    log("phase8 launches on the spec path " + json.dumps(total)
        + f" card {smi}")
    log("phase8 summary " + json.dumps(
        {f"{p} {n}": {k: r[k] for k in ("with_draft", "without_draft",
                                         "acceptance")}
         for (p, n), r in out.items()}) + f" perfect draft "
        + json.dumps({p: r["acceptance"] for p, r in perfect.items()})
        + f" card {smi}")
    return total


# ------------------------------------------------------------------ phase 9

# room for 248 int8 blocks of the 8B (2 GiB at its 32 layers): a block's
# bytes scale with the depth, and so does the room
HOST_BYTES = (2 << 30) * SERVE_LAYERS // 32
HOST_EC = dict(max_slots=8, max_context=4096, kv_pages=129,
               prompt_cache=True, prefill_buckets=(64, 256, 512),
               prefill_chunk=512)
CONV_PROMPT, FOLLOW_UP = 2000, 100
# the preempted requests' budget outlasts the in-flight fused loop (up to
# 64 steps) the drain consumes first
PREEMPT_PROMPT, PREEMPT_AT, PREEMPT_TOKENS = 600, 16, 192
GRPC_PREEMPT_TOKENS = 400


def host_engine(cfg, params, tok, kv, host_bytes=0, kvhost=None):
    """An in-process Engine on phase 5's paged pool (8 slots, 128 usable
    blocks, prompt cache on), with the host tier when `host_bytes` or
    `kvhost` is given."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig

    return Engine(cfg, params, tok, EngineConfig(
        **HOST_EC, cache_type=kv, kv_host_bytes=host_bytes), kvhost=kvhost,
        device="cuda")


def _pump(eng, recs):
    """One engine step; collects each record's outputs (tokens, logprobs,
    text, the terminal output, the first token's time)."""
    busy = eng.step()
    now = time.perf_counter()
    for r in recs:
        while not r["q"].empty():
            o = r["q"].get_nowait()
            r["text"] += o.text
            if o.token_id >= 0:
                if r["ttft"] is None:
                    r["ttft"] = now - r["t0"]
                r["toks"].append(o.token_id)
                r["lps"].append(o.logprob)
            if o.finished:
                r["last"] = o
    return busy


def _submit_all(eng, prompts, resumes=None, max_tokens=NEW_TOKENS):
    """Greedy requests of `max_tokens` tokens for `prompts`, submitted at
    once (with `resumes`, each the ResumeToken its prompt came from, the
    budget net of its emitted tokens). Returns their records."""
    from localai_tpu_torch.engine.engine import GenRequest
    from localai_tpu_torch.ops.sampling import SamplingParams

    recs = []
    for i, ids in enumerate(prompts):
        tok = resumes[i] if resumes else None
        rid, q = eng.submit(GenRequest(
            list(ids), SamplingParams(temperature=0.0),
            max_tokens=max_tokens - (tok.generated if tok else 0),
            ignore_eos=True, logprobs=True,
            resume=tok.payload() if tok else None))
        recs.append(dict(rid=rid, ids=list(ids), q=q,
                         t0=time.perf_counter(), ttft=None, toks=[], lps=[],
                         text="", last=None))
    return recs


def host_wave(eng, prompts, resumes=None, max_tokens=NEW_TOKENS):
    """`prompts` at once, run to the end; every request must finish
    "length". Returns (records, wall seconds)."""
    t0 = time.perf_counter()
    recs = _submit_all(eng, prompts, resumes, max_tokens)
    while _pump(eng, recs):
        pass
    for r in recs:
        if r["last"] is None or r["last"].finish_reason != "length":
            raise AssertionError(f"phase9: a request ended "
                                 f"{r['last'] and r['last'].finish_reason}")
    return recs, time.perf_counter() - t0


def _p50_ms(recs):
    import statistics

    return statistics.median(r["ttft"] for r in recs) * 1e3


def _gained(m0, m1, key):
    return m1[key] - m0[key]


def transfer_rates(eng, blocks=16):
    """The spill and the readmit of `blocks` physical blocks, each timed
    alone with the card synchronized around it (the spill up to its copy
    landing in pinned host memory): median ms a block, and GB/s of the
    block's host bytes (its int8 form). The spill copies into pinned sets
    made up front, as `_spill_block` does (pin_ms_per_block: making one
    set); spill_new_pin_ms into pinned memory allocated for it and kept,
    as a spill past the sets does."""
    import torch

    from localai_tpu_torch.engine.engine import _AsyncFetch, _PinnedBlocks
    from localai_tpu_torch.engine.kvhost import HostKVBlock

    t0 = time.perf_counter()
    sets = _PinnedBlocks(eng._pinned._shapes, blocks)
    pin_ms = (time.perf_counter() - t0) * 1e3 / blocks
    spill, readmit, new_pin, kept = [], [], [], []
    for pb in range(1, blocks + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blk = HostKVBlock(*_AsyncFetch(eng._spill_arrays(pb),
                                       out=sets.take()).tensors())
        spill.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._readmit_block(pb, b"", blk)
        torch.cuda.synchronize()
        readmit.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        kept.append(_AsyncFetch(eng._spill_arrays(pb)).tensors())
        new_pin.append(time.perf_counter() - t0)
    spill_ms = 1e3 * sorted(spill)[blocks // 2]
    readmit_ms = 1e3 * sorted(readmit)[blocks // 2]
    return {"block_bytes": blk.nbytes, "spill_ms_per_block": spill_ms,
            "spill_gb_s": blk.nbytes / spill_ms / 1e6,
            "spill_new_pin_ms_per_block": 1e3 * sorted(new_pin)[blocks // 2],
            "pin_ms_per_block": pin_ms,
            "readmit_ms_per_block": readmit_ms,
            "readmit_gb_s": blk.nbytes / readmit_ms / 1e6}


def host_timers(eng, names=("_host_extend", "_host_drain", "_spill_block",
                             "_readmit_block")):
    """Wrap the engine's host-tier methods `names` so each adds its wall
    ms to the returned dict (nested calls count in both)."""
    acc = dict.fromkeys(names, 0.0)
    for n in names:
        def timed(*a, _fn=getattr(eng, n), _n=n, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                acc[_n] += (time.perf_counter() - t0) * 1e3
        setattr(eng, n, timed)
    return acc


def readmitted_bytes(eng, chains):
    """Of A1's chain blocks now both on the device (hash index) and in the
    host pool: how many there are and how many device pages hold exactly
    the host block's bytes (int8 pool)."""
    import torch

    same = total = 0
    for h in (h for c in chains for h in c):
        pb = eng._hash_index.get(h)
        blk = eng._kvhost.get(h) if pb is not None else None
        if blk is None:
            continue
        total += 1
        dev = [t[:, pb].cpu() for t in (eng._kc.q, eng._kc.s, eng._vc.q,
                                         eng._vc.s)]
        same += all(torch.equal(d, b) for d, b in zip(
            dev, (blk.kq, blk.ks, blk.vq, blk.vs)))
    return total, same


def host_fault(cfg, params, tok, kv, pool, ids):
    """The planted fault: an engine adopting the pool whose readmit drops
    the scales (each block's scale tiles written as 1) serves `ids`; the
    teacher-forced check must reject its tokens."""
    import torch

    from localai_tpu_torch.engine.kvhost import HostKVBlock

    bad = host_engine(cfg, params, tok, kv, kvhost=pool)
    readmit = bad._readmit_block

    def scales_dropped(pb, h, blk):
        readmit(pb, h, HostKVBlock(blk.kq, torch.ones_like(blk.ks), blk.vq,
                                   torch.ones_like(blk.vs)))

    bad._readmit_block = scales_dropped
    recs, _ = host_wave(bad, [ids])
    if bad.metrics["prompt_tokens_reused"] < 128:
        raise AssertionError("phase9: the planted fault readmitted nothing")
    r = recs[0]
    return r["ids"], r["toks"], r["lps"]


def host_tier_leg(name, cfg, params, tok, kv, smi):
    """9.1: waves A1 (8 conversations, 2000-token prompts), A2 (8 unrelated
    2000-token prompts, whose admissions reclaim or rewrite A1's retained
    blocks: they spill) and A3 (A1's follow-up turns: prompt + reply + 100
    new tokens, readmitted from the host tier), on an engine with the tier
    and on one without."""
    import gc

    import torch

    a1 = [prompt_ids(i, CONV_PROMPT, salt=9) for i in range(8)]
    a2 = [prompt_ids(i, CONV_PROMPT, salt=10) for i in range(8)]
    out, w3_tier = {}, None
    for tier in (True, False):
        key = "tier" if tier else "no_tier"
        eng = host_engine(cfg, params, tok, kv, HOST_BYTES if tier else 0)
        w1, _ = host_wave(eng, a1)
        host_wave(eng, a2)
        a3 = [r["ids"] + r["toks"] + _tail(20 + i, FOLLOW_UP)
              for i, r in enumerate(w1)]
        if tier:
            eng._host_drain()
            chains = [eng._chain_hashes(r["ids"] + r["toks"]) for r in w1]
            out["a1_full_blocks"] = sum(len(c) for c in chains)
            out["a1_blocks_on_host_after_a2"] = sum(
                eng._kvhost.contains(h) for c in chains for h in c)
        m2 = dict(eng.metrics)
        timers = host_timers(eng) if tier else None
        w3, wall3 = host_wave(eng, a3)
        m3 = dict(eng.metrics)
        if tier:
            out["a3_host_ms"] = dict(timers)
        out[f"a3_ttft_p50_ms_{key}"] = _p50_ms(w3)
        out[f"a3_tok_s_{key}"] = _gained(m2, m3, "tokens_generated") / wall3
        out[f"a3_prompt_tokens_prefilled_{key}"] = _gained(
            m2, m3, "prompt_tokens_processed")
        if not tier:
            out["a3_tokens_equal_to_tier"] = sum(
                a == b for r, s in zip(w3, w3_tier)
                for a, b in zip(r["toks"], s["toks"]))
            del eng
            gc.collect()
            torch.cuda.empty_cache()
            continue
        w3_tier = w3
        eng._host_drain()
        m3 = dict(eng.metrics)
        out.update(
            a1_a2_spills=m2["kv_host_spills"],
            a3_spills=_gained(m2, m3, "kv_host_spills"),
            a3_host_hits=_gained(m2, m3, "kv_host_hits"),
            a3_prompt_tokens_reused=_gained(m2, m3, "prompt_tokens_reused"),
            host_evictions=m3["kv_host_evictions"],
            host_bytes_peak=m3["kv_host_bytes_peak"],
            host_blocks=m3["kv_host_blocks"])
        if kv:
            out["readmitted_pages_checked"], out[
                "readmitted_pages_byte_equal"] = readmitted_bytes(eng, chains)
        cases = {f"A3 conversation {i}": (r["ids"], r["toks"], r["lps"])
                 for i, r in enumerate(w3[:3])}
        pool = eng._kvhost
        out["transfer"] = transfer_rates(eng)
        ref = check_reference(name, eng, cases, host_fault(
            cfg, params, tok, kv, pool, a3[0]), phase="phase9 host tier")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase9 {name} host tier " + json.dumps(out) + f" card {smi}")
    # every A1 full block reached the host tier; every A3 prompt token
    # reused came from a readmitted block (A1's pages left the device in
    # A2; a hit whose admission then deferred is readmitted again at the
    # retry, so hits may exceed the blocks kept), at least seven of the
    # eight conversations whole (the eighth may lose its tail to the
    # budget: A3's readmissions reclaim A2's blocks, whose spills push the
    # pool past it); the int8 pages readmitted hold the spilled bytes
    if out["a1_blocks_on_host_after_a2"] != out["a1_full_blocks"] \
            or out["a1_a2_spills"] < out["a1_full_blocks"]:
        raise AssertionError(f"phase9 {name}: not every A1 full block "
                             f"reached the host tier {out}")
    if (out["a3_prompt_tokens_reused"] > 128 * out["a3_host_hits"]
            or out["a3_prompt_tokens_reused"]
            < 128 * (7 * out["a1_full_blocks"] // 8)):
        raise AssertionError(f"phase9 {name}: A3's readmission {out}")
    if kv and (out["readmitted_pages_checked"]
               < 3 * out["a1_full_blocks"] // 4
               or out["readmitted_pages_byte_equal"]
               != out["readmitted_pages_checked"]):
        raise AssertionError(f"phase9 {name}: readmitted pages differ "
                             f"from the spilled blocks {out}")
    return out, ref


def preempt_leg(name, cfg, params, tok, kv, smi):
    """9.2: eight greedy 600-token requests preempted mid-decode (each has
    streamed >= 16 tokens) by Engine.preempt(); every ResumeToken resumes
    on a fresh engine adopting the pool (readmit) and on one without a
    pool (re-prefill)."""
    import gc

    import torch

    from localai_tpu_torch.engine.resume import ResumeToken

    prompts = [prompt_ids(i, PREEMPT_PROMPT, salt=11) for i in range(8)]
    eng = host_engine(cfg, params, tok, kv, HOST_BYTES)
    host_wave(eng, [prompt_ids(0, 40, salt=12)])    # its graphs captured
    recs = _submit_all(eng, prompts, max_tokens=PREEMPT_TOKENS)
    while not all(len(r["toks"]) >= PREEMPT_AT for r in recs):
        _pump(eng, recs)
        if any(r["last"] is not None for r in recs):
            raise AssertionError(f"phase9 {name}: a request finished "
                                 f"before the preemption")
    live = sum(s is not None for s in eng._slots)
    t0 = time.perf_counter()
    man = eng.preempt()
    drain_ms = (time.perf_counter() - t0) * 1e3
    _pump(eng, recs)
    ends = [r["last"] and r["last"].finish_reason for r in recs]
    # the manifest is in slot order: each stream's token by request id
    by_rid = {m["request_id"]: ResumeToken.from_dict(m) for m in man}
    toks = [by_rid.get(f"rid-{r['rid']}") for r in recs]
    if ends != ["preempted"] * 8 or live != 8 or any(
            t is None or t.emitted != r["toks"] or t.prompt_ids != r["ids"]
            for t, r in zip(toks, recs)):
        raise AssertionError(f"phase9 {name}: live slots {live}, ends "
                             f"{ends}, or a manifest entry that is not its "
                             f"stream")
    out = {"live_slots": live, "drain_ms": drain_ms,
           "drain_blocks": eng.metrics["preempt_spilled_blocks"],
           "emitted_at_preempt": [t.generated for t in toks]}
    pool = eng._kvhost
    del eng
    gc.collect()
    ref = None
    for mode in ("readmit", "reprefill"):
        fresh = host_engine(cfg, params, tok, kv, kvhost=pool
                            if mode == "readmit" else None)
        host_wave(fresh, [prompt_ids(1, 40, salt=12)])  # graphs captured
        m0 = dict(fresh.metrics)
        rest, _ = host_wave(fresh, [t.resume_prompt for t in toks], toks,
                            PREEMPT_TOKENS)
        m1 = dict(fresh.metrics)
        out[f"resume_ttft_p50_ms_{mode}"] = _p50_ms(rest)
        got = (_gained(m0, m1, "resume_readmits"),
               _gained(m0, m1, "resume_reprefills"))
        out[f"resume_readmits_reprefills_{mode}"] = got
        if got != ((8, 0) if mode == "readmit" else (0, 8)):
            raise AssertionError(f"phase9 {name} {mode}: (readmits, "
                                 f"reprefills) = {got}")
        joined = [r["toks"] + s["toks"] for r, s in zip(recs, rest)]
        for r, s, j in zip(recs, rest, joined):
            if len(j) != PREEMPT_TOKENS or r["text"] + s["text"] \
                    != tok.decode(j):
                raise AssertionError(
                    f"phase9 {name} {mode}: {len(j)} tokens, or the text "
                    f"before and after the preemption is not the stream's "
                    f"(characters repeated or lost)")
        if mode == "readmit":
            cases = {f"resumed {i}": (r["ids"], j, r["lps"] + s["lps"])
                     for i, (r, s, j) in enumerate(
                         zip(recs[:3], rest, joined))}
            fault = (prompt_ids(98, PREEMPT_PROMPT, salt=98), joined[0],
                     recs[0]["lps"] + rest[0]["lps"])
            ref = check_reference(name, fresh, cases, fault,
                                  phase="phase9 preempt")
        del fresh
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase9 {name} preempt " + json.dumps(out) + f" card {smi}")
    return out, ref


def grpc_preempt_leg(d, tok, smi):
    """9.3: a port backend process (`python -m localai_tpu_torch.backend`,
    LoadModel with kv_host_bytes, bf16) streams phase 4's four prompts; it
    gets SIGTERM once every stream has >= 16 tokens. Every stream must end
    "preempted" with a resume_json, the process exit 0, and a new backend
    process resume each stream (re-prefill: the pool died with the
    process) to its budget, the joined text equal to the detokenized
    ids."""
    import re
    import signal
    import sys
    import threading

    env = dict(os.environ, LOCALAI_ALLOW_SYNTHETIC="1",
               LOCALAI_NO_PREWARM="1", PYTHONPATH=HERE)
    load = dict(model=d, dtype="bfloat16", parallel=4, context_size=2048,
                kv_pages=65,
                options=json.dumps({"kv_host_bytes": HOST_BYTES}))

    def backend():
        proc = subprocess.Popen(
            [sys.executable, "-m", "localai_tpu_torch.backend", "--addr",
             "127.0.0.1:0"], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, cwd=HERE)
        line = proc.stdout.readline()
        m = re.search(r"serving on port (\d+)", line)
        if not m:
            proc.kill()
            raise RuntimeError(f"phase9 backend did not start: {line!r}")
        lines = []
        threading.Thread(target=lambda: lines.extend(proc.stdout),
                         daemon=True).start()
        client = _Client(f"127.0.0.1:{m.group(1)}")
        t0 = time.perf_counter()
        r = client.load(**load)
        if not r.success:
            proc.kill()
            raise RuntimeError(f"phase9 LoadModel failed: {r.message}")
        return proc, client, lines, time.perf_counter() - t0

    def streams(client, reqs, on_chunk=None):
        res = [None] * len(reqs)

        def one(i, kw):
            chunks = []
            for c in client.stream(ignore_eos=True,
                                   tokens=GRPC_PREEMPT_TOKENS, **kw):
                chunks.append(c)
                if on_chunk:
                    on_chunk(i, chunks)
            res[i] = chunks

        threads = [threading.Thread(target=one, args=(i, kw))
                   for i, kw in enumerate(reqs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return res

    out = {}
    proc, client, lines, out["load_s"] = backend()
    counts = [0] * len(REQUESTS)
    fired = threading.Event()

    def on_chunk(i, chunks):
        counts[i] = sum(len(c.token_ids) for c in chunks)
        if min(counts) >= PREEMPT_AT and not fired.is_set():
            fired.set()
            out["tokens_at_sigterm"] = list(counts)
            proc.send_signal(signal.SIGTERM)

    reqs = [dict(prompt_ids=prompt_ids(i, n, salt=13), **sp)
            for i, (n, sp) in enumerate(REQUESTS)]
    try:
        first = streams(client, reqs, on_chunk)
        client.close()
        code = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    ends = [c[-1].finish_reason for c in first]
    if code != 0 or ends != ["preempted"] * len(reqs) or not all(
            c[-1].resume_json for c in first):
        raise AssertionError(f"phase9 gRPC: exit {code}, ends {ends}; "
                             + "".join(lines[-20:]))
    out["emitted_at_preempt"] = [sum(len(c.token_ids) for c in s)
                                 for s in first]
    proc, client, lines, out["reload_s"] = backend()
    try:
        rest = streams(client, [dict(kw, resume_json=c[-1].resume_json)
                                for kw, c in zip(reqs, first)])
        out["resume_reprefills"] = client.metrics()["resume_reprefills"]
    finally:
        client.close()
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=120)
    for a, b in zip(first, rest):
        ids = [t for c in a + b for t in c.token_ids]
        text = "".join(c.message.decode() for c in a + b)
        if (b[-1].finish_reason != "length"
                or len(ids) != GRPC_PREEMPT_TOKENS
                or text != tok.decode(ids)):
            raise AssertionError(f"phase9 gRPC resume: finish "
                                 f"{b[-1].finish_reason}, {len(ids)} ids, "
                                 f"or the joined text is not theirs")
    if out["resume_reprefills"] != len(reqs):
        raise AssertionError(f"phase9 gRPC: {out['resume_reprefills']} "
                             f"re-prefill resumes")
    log("phase9 gRPC SIGTERM " + json.dumps(out) + f" card {smi}")
    return out


def phase_host_tier(d, smi, tok):
    """Phase 9, the host KV spill tier, preemption and resume at full
    width: the synthetic Llama-3.1-8B (SERVE_LAYERS of its 32 layers)
    with the grammar
    checkpoint's tokenizer, bf16 then the int8 recipe, on phase 5's paged
    pool with kv_host_bytes = HOST_BYTES (9.1 host tier, 9.2 preempt and
    resume in-process), then the gRPC SIGTERM leg (9.3, bf16). Returns
    the launch counts of the phase."""
    import gc

    import torch

    from localai_tpu_torch.engine.loader import load_config, load_params
    from localai_tpu_torch.ops.kernels import launch_counts, \
        reset_launch_counts

    os.environ["LOCALAI_ALLOW_SYNTHETIC"] = "1"
    t0 = time.perf_counter()
    reset_launch_counts()
    for name, dtype, kv in RECIPES:
        cfg = load_config(d, dtype=dtype)
        params = load_params(d, cfg, dtype=dtype, device="cuda")
        host_tier_leg(name, cfg, params, tok, kv, smi)
        preempt_leg(name, cfg, params, tok, kv, smi)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    grpc = grpc_preempt_leg(d, tok, smi)
    counts = launch_counts()
    log("phase9 launches " + json.dumps(
        {k: counts[k] for k in PAGED_OWN["bf16"] + PAGED_OWN["int8"]})
        + f" ({time.perf_counter() - t0:.1f} s) card {smi}")
    for k in PAGED_OWN["bf16"] + PAGED_OWN["int8"]:
        if counts[k] <= 0:
            raise AssertionError(f"phase9: {k} never launched")
    return counts, grpc


# ----------------------------------------------------------------- phase 10

TIER_EC = dict(max_slots=4, max_context=8192)
TIER_PROMPT, TIER_NEW = 6000, 256
TIER_DROP = "sink_window(sinks=128, window=1024)"
TIER_COLD = "sink_window(sinks=128, window=1024, quantize_cold=true)"
TIER_SAMPLING = [dict(temperature=0.0), dict(temperature=0.0),
                 dict(temperature=0.8, seed=7), dict(temperature=0.0)]
TIER_GREEDY = (0, 1, 3)
# _kv_tick's rule: raw block r >= sink blocks (1) leaves the window once
# (r + 1) * 128 <= n - window. A slot ends at n = 6256; the last tick before
# its release sees at least n = 6256 - 64 (one fused dispatch in flight),
# and 6192 - 1024 >= 40 * 128, so raws 1 .. 39 leave: 39 a slot
TIER_EXITS = (TIER_PROMPT + TIER_NEW - 1024) // 128 - 1
# phase 10's second wave: per-request policies on the windowed engine
TIER_MIXED = ["full", "sink_window(sinks=0, window=512)", "", "full"]
TIER_MIXED_PROMPT, TIER_MIXED_NEW = 1200, 64


# the synthetic Llama-3.1-8B's weights on the card by dtype: phases 10 and
# 11 load each recipe once and phase 11 frees them
WEIGHTS: dict = {}


def recipe_weights(d, dtype):
    """(cfg, params) of the checkpoint at `d` in `dtype`, on the card,
    loaded at the first call (WEIGHTS)."""
    from localai_tpu_torch.engine.loader import load_config, load_params

    if dtype not in WEIGHTS:
        cfg = load_config(d, dtype=dtype)
        WEIGHTS[dtype] = (cfg, load_params(d, cfg, dtype=dtype,
                                           device="cuda"))
    return WEIGHTS[dtype]


def tier_engine(cfg, params, tok, kv, policy, ragged=False):
    """An in-process Engine of phase 10: 4 slots, 8192-token contexts; a
    windowed policy gets a pool of 4 slots' resident blocks + 1 (and with
    quantize_cold a cold pool of 4 full contexts' blocks + 1), the full
    policy a pool of 4 full contexts. Warmed up (graphs captured)."""
    from localai_tpu_torch.engine import kvtier
    from localai_tpu_torch.engine.engine import Engine, EngineConfig
    from localai_tpu_torch.ops.paged import blocks_needed

    ec = dict(TIER_EC, cache_type=kv)
    if ragged:
        ec["ragged_token_budget"] = 192
    pol = kvtier.parse_policy(policy)
    if pol.windowed:
        margin = kvtier.engine_margin_tokens(EngineConfig(**ec))
        ec.update(kv_policy=policy,
                  kv_pages=4 * kvtier.resident_blocks(pol, margin) + 1)
        if pol.quantize_cold:
            ec["kv_cold_pages"] = 4 * blocks_needed(
                TIER_PROMPT + TIER_NEW) + 1
    else:
        ec["kv_pages"] = 4 * blocks_needed(TIER_EC["max_context"]) + 1
    eng = Engine(cfg, params, tok, EngineConfig(**ec), device="cuda")
    eng.warmup()
    return eng


def _replay_events(eng):
    """CUDA events around each fused-loop segment the engine replays from
    here on: [(start, end, steps)]. A segment is one graph launch, so the
    time between its events is the card's time on its steps (it starts
    once the work before it is done; nothing of the host runs inside it):
    the busy ms a decode step of the fused loops."""
    import torch

    marks, run = [], eng.graphs.run

    def timed(key, steps, *a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        run(key, steps, *a, **kw)
        e1.record()
        marks.append((e0, e1, steps))

    eng.graphs.run = timed
    return marks


def _busy_ms_step(marks):
    import torch

    if not marks:
        return None
    torch.cuda.synchronize()
    return (sum(a.elapsed_time(b) for a, b, _ in marks)
            / sum(n for _, _, n in marks))


def tier_wave(eng, salt, sampling=None, policies=None, prompt=None,
              new=None, timed=False):
    """Four requests of `prompt` tokens at once (`sampling`, per-request
    `policies`), run to the end; each must finish "length" with `new`
    tokens. Returns (records, readings): wall s, the s until every slot
    had prefilled, and with `timed` (on the card) the busy ms a decode
    step of the fused loops' replays (_replay_events)."""
    from localai_tpu_torch.engine.engine import GenRequest
    from localai_tpu_torch.ops.sampling import SamplingParams

    sampling = sampling or TIER_SAMPLING
    prompt, new = prompt or TIER_PROMPT, new or TIER_NEW
    marks = _replay_events(eng) if timed else None
    t0 = time.perf_counter()
    recs = []
    for i, sp in enumerate(sampling):
        ids = prompt_ids(i, prompt, salt)
        rid, q = eng.submit(GenRequest(
            ids, SamplingParams(**sp), max_tokens=new, ignore_eos=True,
            logprobs=True, kv_policy=policies[i] if policies else ""))
        recs.append(dict(rid=rid, ids=ids, q=q, t0=time.perf_counter(),
                         ttft=None, toks=[], lps=[], text="", last=None))
    out = {"prefilled_s": None}
    while _pump(eng, recs):
        live = [s for s in eng._slots if s is not None]
        if (out["prefilled_s"] is None and len(live) == len(recs)
                and all(s.prefilled for s in live)):
            out["prefilled_s"] = time.perf_counter() - t0
    out["wall_s"] = time.perf_counter() - t0
    if timed:
        del eng.graphs.run
        out["busy_ms_step"] = _busy_ms_step(marks)
        out["steps_timed"] = sum(n for _, _, n in marks)
    for r in recs:
        if (r["last"] is None or r["last"].finish_reason != "length"
                or len(r["toks"]) != new):
            raise AssertionError(
                f"phase10: a request ended "
                f"{r['last'] and r['last'].finish_reason} after "
                f"{len(r['toks'])} tokens")
    return recs, out


def _tier_forward(engine, seq, n_out, mode, sinks, window, sb):
    """Logits of the last n_out positions of `seq` through a plain forward
    of the engine's model (the weight GEMMs' plain versions within
    plain_weight_gemms; attention in plain PyTorch, 512 queries at a time)
    under the tier's retention: "full" every key k <= q; "drop" keys k <= q
    with k > q - window or k < sinks; "cold" every key k <= q, a key in a
    block the tier demotes before the query — raw >= sb and (raw + 1) * 128
    + window <= q — at its quantize_tokens round trip, bf16(q8 * scale) as
    the reference's dequant gives it. An int8 pool's keys and values are
    all at their round trip, as the pool holds them."""
    import torch

    from localai_tpu_torch.models import llama as tl
    from localai_tpu_torch.ops.attention import NEG_INF
    from localai_tpu_torch.ops.kvcache import is_quant_kind, quantize_tokens
    from localai_tpu_torch.ops.norms import rms_norm
    from localai_tpu_torch.ops.quant import qmatmul
    from localai_tpu_torch.ops.rope import apply_rope

    cfg, params, dev = engine.cfg, engine.params, engine.device
    S, D = len(seq), cfg.head_dim
    KVH, G = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    q8 = is_quant_kind(engine.ec.cache_type)
    pos = torch.arange(S, device=dev)

    def rt(x):
        qq, sc = quantize_tokens(x)
        return (qq.float() * sc[..., None]).to(torch.bfloat16)

    x = tl._embed(params, torch.tensor([seq], device=dev), cfg.tdtype)
    for lp in params.layers:
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = tl._qkv(h, lp, cfg)
        q = apply_rope(q, engine._cos, engine._sin, pos[None])
        k = apply_rope(k, engine._cos, engine._sin, pos[None])
        kh, vh = k[0].to(torch.bfloat16), v[0].to(torch.bfloat16)
        if q8:
            kh, vh = rt(k[0]), rt(v[0])
        kc = vc = None
        if mode == "cold":
            kc, vc = rt(k[0]), rt(v[0])
        out = torch.empty(S, cfg.num_heads, D, dtype=torch.bfloat16,
                          device=dev)
        for a in range(0, S, 512):
            b = min(a + 512, S)
            qc = q[0, a:b].to(torch.bfloat16).reshape(b - a, KVH, G, D)
            kp, qp = pos[:b], pos[a:b]
            mask = kp[None, :] <= qp[:, None]
            if mode == "drop":
                mask &= (kp[None, :] > qp[:, None] - window) \
                    | (kp[None, :] < sinks)
            sc = torch.einsum("qkgd,tkd->kgqt", qc, kh[:b]).float() \
                * D ** -0.5
            if mode == "cold":
                raw = kp // 128
                cold = (raw[None, :] >= sb) \
                    & ((raw[None, :] + 1) * 128 + window <= qp[:, None])
                scc = torch.einsum("qkgd,tkd->kgqt", qc, kc[:b]).float() \
                    * D ** -0.5
                sc = torch.where(cold[None, None], scc, sc)
            sc = torch.where(mask[None, None], sc, NEG_INF)
            p = torch.softmax(sc, -1).to(torch.bfloat16)
            if mode == "cold":
                o = (torch.einsum("kgqt,tkd->qkgd", p * ~cold[None, None],
                                  vh[:b])
                     + torch.einsum("kgqt,tkd->qkgd", p * cold[None, None],
                                    vc[:b]))
            else:
                o = torch.einsum("kgqt,tkd->qkgd", p, vh[:b])
            out[a:b] = o.reshape(b - a, cfg.num_heads, D)
        x = x + qmatmul(out.to(cfg.tdtype).reshape(1, S, -1), lp["wo"])
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        x = x + tl._mlp(h, lp, cfg)
    x = rms_norm(x, params.final_norm, cfg.rms_eps)
    return tl._lm_head(x[0, -n_out:].float(), params)


def tier_reference(label, engine, recs, mode):
    """Three greedy streams of a phase 10 engine against _tier_forward's
    teacher-forced logits under the engine's retention (the served token's
    reference logit within REF_MARGIN of the row's largest, its logprob
    within REF_LP_TOL); the planted fault — the first stream's tokens
    held to another stream's prompt — must fail."""
    import torch

    pol, dev = engine._kv_policy, engine.device
    sinks, window, sb = pol.sinks, pol.window, pol.sink_blocks

    def readings(ids, toks, lps):
        seq = list(ids) + list(toks[:-1])
        key = (id(engine.params), engine.ec.cache_type, mode, sinks, window,
               sb, tuple(seq), len(toks))
        ref = TIER_REFS.get(key)
        if ref is None:
            with torch.no_grad(), plain_weight_gemms():
                ref = TIER_REFS[key] = _tier_forward(
                    engine, seq, len(toks), mode, sinks, window, sb)
        t = torch.tensor(toks, dtype=torch.int64, device=dev)[:, None]
        gap = ref.max(1).values - ref.gather(1, t)[:, 0]
        lp_ref = torch.log_softmax(ref, -1).gather(1, t)[:, 0]
        dlp = (lp_ref - torch.tensor(lps, device=dev)).abs()
        return {"max_gap": float(gap.max()),
                "argmax_equal": int((gap == 0).sum()), "tokens": len(toks),
                "max_dlogprob": float(dlp.max())}

    out = {f"request {i}": readings(recs[i]["ids"], recs[i]["toks"],
                                    recs[i]["lps"]) for i in TIER_GREEDY}
    out["planted fault"] = readings(recs[1]["ids"], recs[0]["toks"],
                                    recs[0]["lps"])
    for name, r in out.items():
        ok = r["max_gap"] <= REF_MARGIN and r["max_dlogprob"] <= REF_LP_TOL
        if name == "planted fault" and ok:
            raise AssertionError(f"phase10 {label}: the reference check does "
                                 f"not reject the planted fault")
        if name != "planted fault" and not ok:
            raise AssertionError(f"phase10 {label} {name}: served greedy "
                                 f"tokens disagree with the reference {r}")
    return out


# the teacher-forced logits of phase 10, by (weights, cache type, retention,
# sequence): the paged and ragged legs of one policy serve the same prompts,
# so a stream they serve alike is forwarded once
TIER_REFS: dict = {}
TIER_OWN = {"bf16": "ragged_decode_paged_tier",
            "int8": "ragged_decode_q8_paged_tier"}
TIER_RAGGED_OWN = {"bf16": "ragged_paged_attention_tier",
                   "int8": "ragged_paged_attention_q8_tier"}
TIER_KERNELS = ("ragged_decode_paged_tier", "ragged_decode_q8_paged_tier",
                "ragged_paged_attention_tier",
                "ragged_paged_attention_q8_tier", "paged_demote_q8")


def tier_leg(label, recipe, cfg, params, tok, kv, policy, ragged, salt,
             smi, mixed=False):
    """One phase 10 engine: the wave of four 6000-token prompts, its checks
    (pool peak, exits, launches, the teacher-forced streams), with `mixed`
    a second wave of per-request policies that must capture no new graph.
    Returns its reading."""
    import gc

    import torch

    from localai_tpu_torch.ops.kernels import launch_counts

    eng = tier_engine(cfg, params, tok, kv, policy, ragged)
    before = launch_counts()
    g0 = eng.graphs.counters()
    t0 = time.perf_counter()
    recs, wave = tier_wave(eng, salt, timed=True)
    after = launch_counts()
    m = dict(eng.metrics)
    launched = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
    pol = eng._kv_policy
    row = {"engine": label, "policy": policy, "ragged": ragged,
           "tok_s": sum(len(r["toks"]) for r in recs) / wave["wall_s"],
           "ttft_p50_ms": _p50_ms(recs), **wave,
           "kv_pages": eng.ec.kv_pages, "kv_blocks_peak": m["kv_blocks_peak"],
           "graphs": graph_delta(g0, eng.graphs.counters()),
           "launches": launched}
    own = (TIER_RAGGED_OWN if ragged else TIER_OWN)[recipe] \
        if pol.windowed else PAGED_OWN[recipe][0]
    if launched.get(own, 0) <= 0:
        raise AssertionError(f"phase10 {label}: {own} never launched")
    if pol.windowed:
        row["resident_blocks"] = eng._kv_resident
        row.update({k: m[k] for k in ("kv_cold_blocks", "kv_evictions",
                                      "kv_recomputes",
                                      "kv_policy_demotions")})
        if m["kv_blocks_peak"] > 4 * eng._kv_resident:
            raise AssertionError(f"phase10 {label}: kv_blocks_peak "
                                 f"{m['kv_blocks_peak']} > 4 x "
                                 f"{eng._kv_resident}")
        want = (0, 4 * TIER_EXITS) if not pol.quantize_cold \
            else (4 * TIER_EXITS, 0)
        if (m["kv_cold_blocks"], m["kv_evictions"]) != want:
            raise AssertionError(f"phase10 {label}: (kv_cold_blocks, "
                                 f"kv_evictions) {m['kv_cold_blocks']}, "
                                 f"{m['kv_evictions']} != {want}")
        untiered = [k for k in ("ragged_decode_paged",
                                "ragged_decode_q8_paged",
                                "ragged_paged_attention",
                                "ragged_paged_attention_q8")
                    if launched.get(k)]
        if untiered:
            raise AssertionError(f"phase10 {label}: untiered reads "
                                 f"{untiered} launched")
        demotes = launched.get("paged_demote_q8", 0)
        if demotes != cfg.num_layers * m["kv_cold_blocks"]:
            raise AssertionError(f"phase10 {label}: {demotes} demote "
                                 f"launches for {m['kv_cold_blocks']} cold "
                                 f"blocks")
    elif any(launched.get(k) for k in TIER_KERNELS):
        raise AssertionError(f"phase10 {label}: the untiered engine "
                             f"launched a tiered kernel")
    mode = ("cold" if pol.quantize_cold else "drop") if pol.windowed \
        else "full"
    t1 = time.perf_counter()
    row["reference"] = tier_reference(label, eng, recs, mode)
    row["reference_s"] = time.perf_counter() - t1
    if mixed:
        c0 = eng.graphs.counters()
        _, wave2 = tier_wave(
            eng, salt + 1, sampling=[dict(temperature=0.0)] * 4,
            policies=TIER_MIXED, prompt=TIER_MIXED_PROMPT,
            new=TIER_MIXED_NEW)
        c1 = eng.graphs.counters()
        caps = {p: c1[p]["captures"] - c0[p]["captures"] for p in c1}
        if any(caps.values()):
            raise AssertionError(f"phase10 {label}: the mixed-policy wave "
                                 f"captured new graphs {caps}")
        row["mixed_wave"] = {"policies": TIER_MIXED,
                             "new_captures": caps,
                             "replays": {p: c1[p]["replays"]
                                         - c0[p]["replays"] for p in c1},
                             "tok_s": 4 * TIER_MIXED_NEW / wave2["wall_s"],
                             "kv_policy_demotions": eng.metrics[
                                 "kv_policy_demotions"]}
    row["leg_s"] = time.perf_counter() - t0
    log(f"phase10 {label} " + json.dumps(row) + f" card {smi}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_kv_tier(d, smi, tok, demote):
    """Phase 10, the KV retention tier at full width: the synthetic
    Llama-3.1-8B (SERVE_LAYERS of its 32 layers) with the grammar checkpoint's
    tokenizer, in-process Engines of 4 slots and 8192-token contexts serving
    four 6000-token prompts of 256 new tokens (three greedy, one seeded): the
    full policy; sink_window(sinks=128, window=1024) on the paged path and on
    the ragged path (budget 192), bf16 and the int8 recipe; with quantize_cold
    over a bf16 pool (paged: the reference refuses the cold tier with ragged);
    then the gRPC backend's LoadModel with kv_policy in its options serving
    phase 4's prompts. Returns the phase's launch counts."""
    from localai_tpu_torch.ops.kernels import launch_counts, \
        reset_launch_counts

    os.environ["LOCALAI_ALLOW_SYNTHETIC"] = "1"
    t0 = time.perf_counter()
    reset_launch_counts()
    rows = []
    # (label, policy, ragged, mixed wave, prompt salt): a policy's paged
    # and ragged legs serve the same prompts (TIER_REFS)
    legs = {"bf16": [("bf16 full", "full", False, False, 0),
                     ("bf16 drop paged", TIER_DROP, False, True, 1),
                     ("bf16 drop ragged", TIER_DROP, True, False, 1),
                     ("bf16 cold paged", TIER_COLD, False, False, 3)],
            "int8": [("int8 drop paged", TIER_DROP, False, False, 0),
                     ("int8 drop ragged", TIER_DROP, True, False, 0)]}
    for salt, (name, dtype, kv) in enumerate(RECIPES):
        cfg, params = recipe_weights(d, dtype)
        for label, policy, ragged, mixed, j in legs[name]:
            rows.append(tier_leg(label, name, cfg, params, tok, kv, policy,
                                 ragged, 31 + 7 * salt + j, smi, mixed))
        TIER_REFS.clear()
    before = launch_counts()
    grpc_row = serve_recipe(
        "bf16 kv tier", d, dict(dtype="bfloat16"), phase="phase10",
        load_opts=dict(parallel=4, context_size=2048, kv_pages=61,
                       options=json.dumps({"kv_policy": TIER_DROP})))
    after = launch_counts()
    if (after["ragged_decode_paged_tier"] <= before["ragged_decode_paged_tier"]
            or after["ragged_decode_paged"] != before["ragged_decode_paged"]):
        raise AssertionError("phase10 gRPC: the tiered paged decode did not "
                             "serve the stream alone")
    for k in ("kv_evictions", "kv_cold_blocks", "kv_blocks_peak"):
        if k not in grpc_row["metrics_after"]:
            raise AssertionError(f"phase10 gRPC: GetMetrics lacks {k}")
    counts = launch_counts()
    log("phase10 summary " + json.dumps({
        "tok_s": {r["engine"]: r["tok_s"] for r in rows},
        "ttft_p50_ms": {r["engine"]: r["ttft_p50_ms"] for r in rows},
        "busy_ms_step": {r["engine"]: r["busy_ms_step"] for r in rows},
        "kv_blocks_peak": {r["engine"]: r["kv_blocks_peak"] for r in rows},
        "demote_ms_block": demote["ms_block"],
        "demote_ms_layer": demote["ms"],
        "tiered_launches": {k: counts[k] for k in TIER_KERNELS},
        "grpc": {"tok_s": grpc_row["tok_s"],
                 "ttft_p50_ms": grpc_row["ttft_p50_ms"]}})
        + f" ({time.perf_counter() - t0:.1f} s) card {smi}")
    return counts


# ----------------------------------------------------------------- phase 11

# 11.1: engines of 4 slots and 1024-token contexts (shift_keep 4, the
# default), four 900-token prompts of 700 new tokens each, all with
# context_shift (three greedy, one seeded). A dense shift drops (1024 -
# 4) // 2 = 510 tokens, a paged one 3 blocks (keep 1 block, drop (8 - 1)
# // 2): either way each stream shifts exactly twice (at tokens 122 and
# 632 dense, 122 and 506 paged; a third would fall past 700)
SHIFT_EC = dict(max_slots=4, max_context=1024)
SHIFT_PROMPT, SHIFT_NEW = 900, 700
SHIFT_SAMPLING = [dict(temperature=0.0), dict(temperature=0.0),
                  dict(temperature=0.8, seed=11), dict(temperature=0.0)]
SHIFT_GREEDY = (0, 1, 3)
SHIFT_PAGES = 4 * 8 + 1 + 8      # four contexts, the trash block, and
#                                  room for 11.2's retained tenant
SHIFT_LEGS = [("bf16 dense", "bf16", "dense"), ("int8 dense", "int8", "dense"),
              ("bf16 paged", "bf16", "paged"), ("int8 paged", "int8", "paged"),
              ("bf16 ragged", "bf16", "ragged")]
DENSE_OWN = {"bf16": ("ragged_decode",), "int8": ("ragged_decode_q8",)}
# 11.2: the prefix P (four full blocks) of the shared-pages leg
SHIFT_SHARED = 512
# 11.3: the disk prompt cache, dense engines of 2 slots and 4096-token
# contexts: an 1800-token prompt, then its follow-up (+200 tokens, 64 new)
DISK_EC = dict(max_slots=2, max_context=4096)
DISK_PROMPT, DISK_FOLLOW, DISK_NEW = 1800, 200, 64
# the slot's K and V rows right after a shift against the reference
# cache's, relative norm of the difference: bf16 K/V computed by the
# kernels against the plain forward differ by a few bf16 steps (about
# 2**-8 relative each); a shift without the K rotation turns most of K's
# channel pairs by hundreds of radians (error near 1)
SHIFT_KV_TOL = 0.05


@contextlib.contextmanager
def plain_calls():
    """Within: every kernel wrapper's plain version counts its calls
    ({name: calls}); a wrapper given CUDA tensors launches its kernel, so
    a serving run on the card must leave the counts at 0."""
    from localai_tpu_torch.ops.kernels import flash_attention, paged_scatter, \
        ragged_attention, weight_gemm

    counts, saved = {}, []
    for mod in (flash_attention, paged_scatter, ragged_attention,
                weight_gemm):
        for name in dir(mod):
            fn = getattr(mod, name)
            if not (name.endswith("_plain") and callable(fn)):
                continue

            def counted(*a, _fn=fn, _name=name, **kw):
                counts[_name] = counts.get(_name, 0) + 1
                return _fn(*a, **kw)

            saved.append((mod, name, fn))
            setattr(mod, name, counted)
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def shift_engine(cfg, params, tok, kv, path, **kw):
    """An in-process Engine of phase 11.1 on `path` (dense, paged: the pool
    of SHIFT_PAGES, ragged: the same pool and a budget of 192), warmed up
    (graphs captured)."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig

    ec = dict(SHIFT_EC, cache_type=kv, **kw)
    if path != "dense":
        ec["kv_pages"] = SHIFT_PAGES
    if path == "ragged":
        ec["ragged_token_budget"] = 192
    eng = Engine(cfg, params, tok, EngineConfig(**ec), device="cuda")
    eng.warmup()
    return eng


def slot_rows(eng, idx, n):
    """Slot idx's first n K and V rows, [L, KVH, n, D] bf16 each (an int8
    cache dequantized), read through its block table when paged."""
    import torch

    from localai_tpu_torch.ops.kvcache import dequant

    out = []
    for c in (eng._kc, eng._vc):
        if eng._paged:
            blocks = torch.tensor(eng._table[idx], dtype=torch.int64,
                                  device=eng.device)
            x = dequant(c[:, blocks])               # [L, MAXB, KVH, 128, D]
            L, nb, kvh, bs, dd = x.shape
            x = x.permute(0, 2, 1, 3, 4).reshape(L, kvh, nb * bs, dd)
        else:
            x = dequant(c[:, idx])
        out.append(x[:, :, :n].to(torch.bfloat16).clone())
    return out


def shift_probe(eng):
    """Wrap the engine's _dev_shift: a record a shift — the request, the
    tokens it had emitted, its device length right after (one host sync,
    after the timed call) and the slot's K and V rows then (slot_rows),
    the device ms (CUDA events around the call: the first waits for the
    work enqueued before it, so the two time the shift's own kernels), the
    host ms of the call, the graph runner's counters before it and whether
    the slot held every page it had alone (paged). Returns the list of
    records."""
    import torch

    eng.__dict__.pop("_dev_shift", None)      # an earlier probe's wrapper
    recs, run = [], eng._dev_shift

    def probe(idx):
        slot = eng._slots[idx]
        rec = dict(rid=slot.request_id, generated=slot.generated,
                   graphs=eng.graphs.counters())
        if eng._paged:
            rec["owned"] = all(eng._block_ref[b] == 1
                               for b in eng._slot_blocks[idx])
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        run(idx)
        e1.record()
        rec["host_ms"] = (time.perf_counter() - t0) * 1e3
        rec["events"] = (e0, e1)
        rec["length_after"] = int(eng._lengths[idx])
        rec["kv"] = slot_rows(eng, idx, rec["length_after"])
        recs.append(rec)

    eng._dev_shift = probe
    return recs


def shift_geometry(eng):
    """(keep, discard) rows of the engine's shift."""
    if eng._paged:
        return eng._shift_keepb * 128, eng._shift_discard
    return eng.ec.shift_keep, eng._shift_discard


def plain_shift(kc, vc, n, keep, discard, rotate=True):
    """The reference's context shift of a one-slot dense cache [L, 1, KVH,
    T, D] with n rows, written apart from models.llama's: rows [keep +
    discard, n) move to [keep, n - discard); K turns back by `discard`
    positions as complex numbers (channel i the real part, i + D/2 the
    imaginary) times e^(-i·discard·inv_freq) in f64; V moves as it is. An
    int8 cache moves in f32 and is quantized again whole (quantize_tokens).
    `rotate` False: the slide alone (the planted fault's shift)."""
    import torch

    from localai_tpu_torch.ops.kvcache import QuantKV, dequant, quantize_tokens
    from localai_tpu_torch.ops.rope import rope_freqs

    def dense(c):
        return (dequant(c, torch.float32) if isinstance(c, QuantKV)
                else c.float())[:, 0].clone()

    def store(c, x):
        if isinstance(c, QuantKV):
            q, s = quantize_tokens(x)
            c.q[:, 0] = q
            c.s[:, 0] = s.reshape(c.s[:, 0].shape)
        else:
            c[:, 0] = x.to(c.dtype)

    k, v = dense(kc), dense(vc)
    src, dst = slice(keep + discard, n), slice(keep, n - discard)
    ks = k[:, :, src].clone()
    if rotate:
        half = ks.shape[-1] // 2
        inv = rope_freqs(PLAIN_SHIFT_CFG[0])[0].double().to(ks.device)
        z = torch.complex(ks[..., :half].double(), ks[..., half:].double())
        z = z * torch.polar(torch.ones_like(inv), -discard * inv)
        ks = torch.cat([z.real, z.imag], dim=-1).float()
    k[:, :, dst] = ks
    v[:, :, dst] = v[:, :, src].clone()
    store(kc, k)
    store(vc, v)


# the rope of the model under check (set by shift_reference)
PLAIN_SHIFT_CFG = [None]


def shift_reference(engine, ids, toks, shifts, rotate=True, kv=()):
    """The logits that predicted each served token of a stream with
    context shifts, by the port's plain forward (models.llama.extend over
    a one-slot dense cache, plain attention, the weight GEMMs' plain
    versions) carried through the same shifts: the rows the engine wrote
    before shift k (`shifts[k]`, counted over the whole stream) go in,
    plain_shift moves the cache as the engine's shift should, and the
    next rows go in at their new positions. The K/V of every row is then
    what the engine's cache should hold: computed with the history it had
    when written. `kv`: the engine's K and V rows right after each shift
    (slot_rows), held against the reference cache's then. Returns
    ([len(toks), V] f32 logits, [(K, V) relative error a shift]): the
    error is ||engine - reference|| / ||reference|| over the rows."""
    import torch

    from localai_tpu_torch.models.llama import extend, init_kv_cache

    cfg, dev = engine.cfg, engine.device
    keep, discard = shift_geometry(engine)
    PLAIN_SHIFT_CFG[0] = cfg.rope
    seq, P = list(ids) + list(toks), len(ids)
    kc, vc = init_kv_cache(cfg, 1, engine.ec.max_context + 8,
                           cache_type=engine.ec.cache_type, device=dev)
    out = torch.empty((len(toks), cfg.vocab_size), dtype=torch.float32,
                      device=dev)
    a = pos = 0
    errs = []
    for k, end in enumerate(list(shifts) + [len(seq) - 1]):
        with torch.no_grad(), plain_weight_gemms():
            logits = extend(engine.params, cfg,
                            torch.tensor([seq[a:end]], dtype=torch.int32,
                                         device=dev),
                            torch.tensor([pos], dtype=torch.int32,
                                         device=dev),
                            engine._cos, engine._sin, kc, vc)[0].float()
        lo = max(a, P - 1)          # row r predicted seq[r + 1]
        out[lo + 1 - P:end + 1 - P] = logits[lo - a:end - a]
        pos += end - a
        a = end
        if k < len(shifts):
            with torch.no_grad():
                plain_shift(kc, vc, pos, keep, discard, rotate)
            pos -= discard
            if k < len(kv):
                errs.append(tuple(
                    float((got.float() - want.float()).norm()
                          / want.float().norm())
                    for got, want in zip(kv[k], slot_rows(
                        SimpleNamespace(_kc=kc, _vc=vc, _paged=False), 0,
                        pos))))
    return out, errs


def stream_shifts(probe, rid, discard):
    """The rows a stream had written (over the whole stream) at each of its
    shifts: the device length after it, plus its discards so far."""
    mine = [p for p in probe if p["rid"] == rid]
    return [p["length_after"] + discard * (k + 1)
            for k, p in enumerate(mine)]


def shift_check(label, engine, probe, recs, greedy, fault=None):
    """The teacher-forced check of greedy streams served with shifts: each
    served token's reference logit within REF_MARGIN of its row's largest
    and its logprob within REF_LP_TOL of the reference's, and the slot's K
    and V rows right after each shift within SHIFT_KV_TOL (relative
    norm) of the reference cache's. `fault`: a record of a stream served
    by the planted fault (a shift without the K rotation), which must
    fail. Returns the readings."""
    import torch

    dev = engine.device
    _, discard = shift_geometry(engine)

    def readings(r):
        ref, errs = shift_reference(
            engine, r["ids"], r["toks"],
            stream_shifts(probe, r["rid"], discard),
            kv=[p["kv"] for p in probe if p["rid"] == r["rid"]])
        t = torch.tensor(r["toks"], dtype=torch.int64, device=dev)[:, None]
        gap = ref.max(1).values - ref.gather(1, t)[:, 0]
        lp_ref = torch.log_softmax(ref, -1).gather(1, t)[:, 0]
        dlp = (lp_ref - torch.tensor(r["lps"], device=dev)).abs()
        return {"max_gap": float(gap.max()),
                "argmax_equal": int((gap == 0).sum()),
                "tokens": len(r["toks"]),
                "max_dlogprob": float(dlp.max()),
                "shifts": len(errs),
                "kv_rel_err": max([max(e) for e in errs], default=0.0)}

    out = {f"request {i}": readings(recs[i]) for i in greedy}
    if fault is not None:
        out["planted fault"] = readings(fault)
    for name, r in out.items():
        ok = (r["max_gap"] <= REF_MARGIN and r["max_dlogprob"] <= REF_LP_TOL
              and r["kv_rel_err"] <= SHIFT_KV_TOL)
        if name == "planted fault" and ok:
            raise AssertionError(f"phase11 {label}: the reference check does "
                                 f"not reject the planted fault {r}")
        if name != "planted fault" and not ok:
            raise AssertionError(f"phase11 {label} {name}: served greedy "
                                 f"tokens disagree with the reference {r}")
    return out


def shift_submit(eng, ids, sp, new, **kw):
    """Submit one request (logprobs on); its record for _pump."""
    from localai_tpu_torch.engine.engine import GenRequest
    from localai_tpu_torch.ops.sampling import SamplingParams

    rid, q = eng.submit(GenRequest(list(ids), SamplingParams(**sp),
                                   max_tokens=new, ignore_eos=True,
                                   logprobs=True, **kw))
    return dict(rid=rid, ids=list(ids), q=q, t0=time.perf_counter(),
                ttft=None, toks=[], lps=[], text="", last=None)


def finished_length(label, recs, new):
    for r in recs:
        if (r["last"] is None or r["last"].finish_reason != "length"
                or len(r["toks"]) != new):
            raise AssertionError(
                f"phase11 {label}: a request ended "
                f"{r['last'] and r['last'].finish_reason} after "
                f"{len(r['toks'])} tokens (budget {new})")


def shift_timings(probe):
    """Device and host ms of each shift (the events synchronized)."""
    import torch

    torch.cuda.synchronize()
    return ([round(a.elapsed_time(b), 4)
             for a, b in (p["events"] for p in probe)],
            [round(p["host_ms"], 3) for p in probe])


def shift_leg(label, recipe, cfg, params, tok, kv, path, salt):
    """One phase 11.1 engine: the wave of four 900-token prompts of 700
    shifting tokens, its checks (every stream to its budget, exactly two
    shifts a stream, the path's decode kernels launched and no plain
    version ran, no graph captured in the wave and replays after every
    shift, the teacher-forced streams). Returns (reading, engine, its
    shift probe, the wave's records)."""
    from localai_tpu_torch.ops.kernels import launch_counts

    eng = shift_engine(cfg, params, tok, kv, path)
    probe = shift_probe(eng)
    before, g0 = launch_counts(), eng.graphs.counters()
    marks = _replay_events(eng)
    t0 = time.perf_counter()
    with plain_calls() as plain:
        recs = [shift_submit(eng, prompt_ids(i, SHIFT_PROMPT, salt), sp,
                             SHIFT_NEW, context_shift=True)
                for i, sp in enumerate(SHIFT_SAMPLING)]
        while _pump(eng, recs):
            pass
    wall = time.perf_counter() - t0
    del eng.graphs.run
    busy = _busy_ms_step(marks)
    after, g1 = launch_counts(), eng.graphs.counters()
    finished_length(label, recs, SHIFT_NEW)
    launched = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
    own = {"dense": DENSE_OWN, "paged": PAGED_OWN,
           "ragged": RAGGED_OWN}[path][recipe]
    for k in own:
        if launched.get(k, 0) <= 0:
            raise AssertionError(f"phase11 {label}: {k} never launched")
    if plain:
        raise AssertionError(f"phase11 {label}: plain versions ran {plain}")
    per = [sum(p["rid"] == r["rid"] for p in probe) for r in recs]
    if per != [2] * len(recs):
        raise AssertionError(f"phase11 {label}: shifts a stream {per}, "
                             f"not 2 each")
    caps = {p: c["captures"] - g0.get(p, {}).get("captures", 0)
            for p, c in g1.items()}
    if any(caps.values()):
        raise AssertionError(f"phase11 {label}: the wave captured graphs "
                             f"{caps}")
    total = sum(c["replays"] for c in g1.values())
    for p in probe:
        if total <= sum(c["replays"] for c in p["graphs"].values()):
            raise AssertionError(f"phase11 {label}: no graph replay after a "
                                 f"shift")
    if eng._paged and not all(p["owned"] for p in probe):
        raise AssertionError(f"phase11 {label}: a shift rotated a page "
                             f"another tenant held")
    dev_ms, host_ms = shift_timings(probe)
    row = {"engine": label, "tok_s": len(recs) * SHIFT_NEW / wall,
           "ttft_p50_ms": _p50_ms(recs), "wall_s": wall,
           "shifts_per_stream": per, "shift_device_ms": dev_ms,
           "shift_host_ms": host_ms, "busy_ms_step": busy,
           "graphs": graph_delta(g0, g1),
           "launches": {k: launched.get(k, 0) for k in own}}
    return row, eng, probe, recs


def shift_fault(eng, salt):
    """The planted fault: the engine's shift turned into a slide without
    the K rotation (rotation by 0), one greedy stream served through its
    first shift. Returns (its record, the probe)."""
    import torch

    c, s = eng._shift_rot
    eng._shift_rot = (torch.ones_like(c), torch.zeros_like(s))
    probe = shift_probe(eng)
    rec = shift_submit(eng, prompt_ids(0, SHIFT_PROMPT, salt),
                       dict(temperature=0.0), 250, context_shift=True)
    while _pump(eng, [rec]):
        pass
    eng._shift_rot = (c, s)
    return rec, probe


def shared_pages_leg(eng, salt=77):
    """Phase 11.2 on the paged bf16 engine (after 11.1's wave): A serves
    the 512-token prefix P and is retained (its full blocks in the hash
    index); D (P + a tail) takes A's slot by its slot prompt cache and
    decodes on, holding A's blocks; B (P + 388 tokens, shifting) would
    borrow them, but takes lcp 0 and owns its pages; once B has shifted
    twice and D has ended, C (P) reuses A's blocks and must stream A's
    tokens (a bf16 near-tie aside). Returns the reading."""
    P = prompt_ids(0, SHIFT_SHARED, salt)
    probe = shift_probe(eng)
    m = eng.metrics
    a = shift_submit(eng, P, dict(temperature=0.0), 16)
    while _pump(eng, [a]):
        pass
    reused0 = m["prompt_tokens_reused"]
    d = shift_submit(eng, P + _tail(3, 32), dict(temperature=0.0), 64)
    _pump(eng, [d])
    reused_d = m["prompt_tokens_reused"] - reused0
    b = shift_submit(eng, P + _tail(4, SHIFT_PROMPT - SHIFT_SHARED),
                     dict(temperature=0.0), 520, context_shift=True)
    recs = [d, b]
    while ((sum(p["rid"] == b["rid"] for p in probe) < 2
            or d["last"] is None) and b["last"] is None):
        _pump(eng, recs)
    reused_b = m["prompt_tokens_reused"] - reused0 - reused_d
    c = shift_submit(eng, P, dict(temperature=0.0), 16)
    recs.append(c)
    while _pump(eng, recs):
        pass
    reused_c = m["prompt_tokens_reused"] - reused0 - reused_d - reused_b
    finished_length("11.2", [a, c], 16)
    finished_length("11.2", [b], 520)
    if reused_d < SHIFT_SHARED or reused_b != 0 or reused_c < 3 * 128:
        raise AssertionError(f"phase11 11.2: prompt tokens reused D "
                             f"{reused_d}, B {reused_b}, C {reused_c}")
    if not all(p["owned"] for p in probe) or len(probe) != 2:
        raise AssertionError("phase11 11.2: B's shifts rotated pages "
                             "another tenant held, or B did not shift twice")
    checks = shift_check("11.2", eng, probe, [b, c], (0, 1))
    same = c["toks"] == a["toks"]
    if not same:
        # a bf16 near-tie: C's last prompt row came from a 1-row extend,
        # A's from a 256-row chunk; at the first token that differs both
        # must be within REF_MARGIN of C's reference row's largest logit
        import torch

        j = next(i for i, (x, y) in enumerate(zip(a["toks"], c["toks"]))
                 if x != y)
        ref, _ = shift_reference(eng, c["ids"], c["toks"], [])
        gap = float(ref[j].max() - ref[j, a["toks"][j]])
        if gap > REF_MARGIN:
            raise AssertionError(f"phase11 11.2: C left A's stream at token "
                                 f"{j} (gap {gap})")
    return {"reused": {"D": reused_d, "B": reused_b, "C": reused_c},
            "C_equals_A": same, "B_shifts": len(probe),
            "reference": checks}


def disk_leg(recipe, cfg, params, tok, kv, tmp):
    """Phase 11.3 for one recipe: an engine serves DISK_PROMPT tokens with
    prompt_cache_path and writes the file at release; a fresh engine
    (prompt_cache off, so nothing but the file is reused) serves the
    follow-up cold, then from the file (prompt_cache_hits 1,
    prompt_tokens_reused DISK_PROMPT, the teacher-forced check), then
    read-only (the file's bytes and mtime unchanged). Returns the
    reading."""
    import hashlib

    import torch

    from localai_tpu_torch.engine.engine import Engine, EngineConfig

    def timer(eng, name, acc):
        fn = getattr(eng, name)

        def timed(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            acc.append((time.perf_counter() - t) * 1e3)
            return out

        setattr(eng, name, timed)

    def serve(eng, ids, **kw):
        """One greedy request to its end; its record, with `prefill_ms`:
        submit to its prefill done on the card (the host clock around the
        admission ticks, the card synchronized once the slot is
        prefilled)."""
        r = shift_submit(eng, ids, dict(temperature=0.0), DISK_NEW, **kw)
        while r["last"] is None and not any(
                s is not None and s.request_id == r["rid"] and s.prefilled
                for s in eng._slots):
            _pump(eng, [r])
        torch.cuda.synchronize()
        r["prefill_ms"] = (time.perf_counter() - r["t0"]) * 1e3
        while _pump(eng, [r]):
            pass
        finished_length(f"11.3 {recipe}", [r], DISK_NEW)
        return r

    def digest():
        with open(path, "rb") as f:
            h = hashlib.sha256(f.read()).hexdigest()
        return h, os.stat(path).st_mtime_ns

    path = os.path.join(tmp, f"prompt-{recipe}.kv.npz")
    prompt = prompt_ids(0, DISK_PROMPT, salt=91)
    follow = prompt + prompt_ids(1, DISK_FOLLOW, salt=92)
    e1 = Engine(cfg, params, tok, EngineConfig(**DISK_EC, cache_type=kv),
                device="cuda")
    saves, loads = [], []
    timer(e1, "_save_prompt_cache", saves)
    serve(e1, prompt, prompt_cache_path=path)
    mb = os.path.getsize(path) / 2 ** 20
    del e1
    e2 = Engine(cfg, params, tok, EngineConfig(
        **DISK_EC, cache_type=kv, prompt_cache=False), device="cuda")
    e2.warmup()
    timer(e2, "_load_prompt_cache", loads)
    cold = serve(e2, follow)
    m0 = dict(e2.metrics)
    hot = serve(e2, follow, prompt_cache_path=path)
    m1 = dict(e2.metrics)
    hits = m1["prompt_cache_hits"] - m0["prompt_cache_hits"]
    reused = m1["prompt_tokens_reused"] - m0["prompt_tokens_reused"]
    if (hits, reused) != (1, DISK_PROMPT):
        raise AssertionError(f"phase11 11.3 {recipe}: prompt_cache_hits "
                             f"{hits}, prompt_tokens_reused {reused}")
    ref = check_reference(
        f"{recipe} disk follow-up", e2,
        {"follow-up": (follow, hot["toks"], hot["lps"])},
        (prompt_ids(2, DISK_PROMPT + DISK_FOLLOW, salt=93), hot["toks"],
         hot["lps"]), phase="phase11")
    stamp = digest()
    m2 = dict(e2.metrics)
    serve(e2, follow, prompt_cache_path=path, prompt_cache_ro=True)
    if e2.metrics["prompt_cache_hits"] != m2["prompt_cache_hits"] + 1:
        raise AssertionError(f"phase11 11.3 {recipe}: the read-only load "
                             f"missed")
    if digest() != stamp:
        raise AssertionError(f"phase11 11.3 {recipe}: prompt_cache_ro "
                             f"changed the file")
    os.remove(path)
    return {"file_mb": round(mb, 1), "save_ms": saves, "load_ms": loads,
            "ttft_file_ms": hot["ttft"] * 1e3,
            "ttft_cold_ms": cold["ttft"] * 1e3,
            "prefill_file_ms": hot["prefill_ms"],
            "prefill_cold_ms": cold["prefill_ms"],
            "reused": reused, "reference": ref}


def phase_shift(d, smi, tok):
    """Phase 11, context shift and the disk prompt cache at full width: the
    synthetic Llama-3.1-8B (SERVE_LAYERS of its 32 layers) with the grammar
    checkpoint's tokenizer. 11.1: in-process Engines of 4 slots and 1024-token
    contexts (dense bf16 and int8, paged bf16 and int8, ragged bf16 with a
    budget of 192) serve four 900-token prompts of 700 shifting tokens; the
    dense bf16 engine then serves the planted fault. 11.2: shared pages on the
    paged bf16 engine. 11.3: the disk prompt cache, dense bf16 then int8.
    Returns the phase's launch counts."""
    import gc
    import tempfile

    import torch

    from localai_tpu_torch.ops.kernels import launch_counts, \
        reset_launch_counts

    os.environ["LOCALAI_ALLOW_SYNTHETIC"] = "1"
    t0 = time.perf_counter()
    reset_launch_counts()
    rows, disk = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for salt, (name, dtype, kv) in enumerate(RECIPES):
            cfg, params = recipe_weights(d, dtype)
            for j, (label, recipe, path) in enumerate(SHIFT_LEGS):
                if recipe != name:
                    continue
                row, eng, probe, recs = shift_leg(
                    label, recipe, cfg, params, tok, kv, path,
                    101 + 7 * salt + j)
                fault = None
                if label == "bf16 dense":
                    fault, fprobe = shift_fault(eng, 131)
                    probe = probe + fprobe
                t1 = time.perf_counter()
                row["reference"] = shift_check(label, eng, probe, recs,
                                               SHIFT_GREEDY, fault)
                row["reference_s"] = time.perf_counter() - t1
                if label == "bf16 paged":
                    row["shared_pages"] = shared_pages_leg(eng)
                log(f"phase11 {label} " + json.dumps(row) + f" card {smi}")
                rows.append(row)
                del eng
                gc.collect()
                torch.cuda.empty_cache()
            disk[name] = disk_leg(name, cfg, params, tok, kv, tmp)
            log(f"phase11 {name} disk prompt cache "
                + json.dumps(disk[name]) + f" card {smi}")
    del params
    WEIGHTS.clear()
    gc.collect()
    torch.cuda.empty_cache()
    counts = launch_counts()
    log("phase11 summary " + json.dumps({
        "tok_s": {r["engine"]: r["tok_s"] for r in rows},
        "ttft_p50_ms": {r["engine"]: r["ttft_p50_ms"] for r in rows},
        "busy_ms_step": {r["engine"]: r["busy_ms_step"] for r in rows},
        "shift_device_ms": {r["engine"]: r["shift_device_ms"] for r in rows},
        "shift_host_ms": {r["engine"]: r["shift_host_ms"] for r in rows},
        "disk": {k: {x: v[x] for x in ("file_mb", "save_ms", "load_ms",
                                        "ttft_file_ms", "ttft_cold_ms",
                                        "prefill_file_ms",
                                        "prefill_cold_ms")}
                 for k, v in disk.items()}})
        + f" ({time.perf_counter() - t0:.1f} s) card {smi}")
    return counts


# ------------------------------------------------------------------ phase 12

# Mixtral-8x7B's published widths (HF config.json of
# mistralai/Mixtral-8x7B-v0.1): 8 experts, top-2, untied head, no sliding
# window
CFG_MIXTRAL = {
    "architectures": ["MixtralForCausalLM"],
    "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 128,
    "max_position_embeddings": 32768, "rms_norm_eps": 1e-5,
    "rope_theta": 1e6, "tie_word_embeddings": False,
    "num_local_experts": 8, "num_experts_per_tok": 2,
    "sliding_window": None,
}
# the bf16 leg's depth: 32 layers of bf16 weights (93 GB) exceed the
# card's 80 GB
MIXTRAL_BF16_LAYERS = 16
MIXTRAL_BF16_REQUEST = 2           # the 300-token greedy request
# The teacher-forced bar of the top-2 legs. Top-k routing is a
# discontinuous function of the hidden state: where a token's k-th and
# (k+1)-th router probabilities nearly tie, the bf16-level differences
# between the served path and the plain forward (other kernels, another
# summation order, decode against the window's extend) pick the other
# expert, and every later row attends to the moved K/V. At these widths
# that moved the served rows' logits by up to 0.77 on an H100 (47-54 of
# 64 served tokens the reference's argmax; PERF.md §6); the same streams
# through the plain versions on the CPU at 16 layers, 0.73, and with every
# expert routed (top-8, a continuous combine), 0.015. The control leg
# (mixtral_control) runs the same weights top-8 on the card and is held to
# phase 5-11's 0.25; the top-2 legs to ROUTE_MARGIN, which the planted
# fault (5.8-7.1) still exceeds several times over.
ROUTE_MARGIN = 1.5
# the kernels each leg of phases 12 and 13 must launch, by its label (the
# dense leg's decode kernel second: check_fused_path reads it)
_RAGGED_Q8 = ("ragged_paged_attention_q8", "ragged_scatter_append_q8",
              "ragged_decode_q8_paged", "paged_scatter_append_q8")
_INT4 = ("w4a16_matmul", "head_matmul_int4")
LEG_OWN = {
    "int8 dense": ("flash_prefill", "ragged_decode_q8", "moe_w8_matmul"),
    "int8 ragged": _RAGGED_Q8 + ("moe_w8_matmul",),
    "bf16 dense": ("flash_prefill", "ragged_decode"),
    "int8 dense top-8 control": ("flash_prefill", "ragged_decode_q8",
                                 "moe_w8_matmul"),
    "8b int4 dense": ("flash_prefill", "ragged_decode_q8") + _INT4,
    "8b int4 ragged": _RAGGED_Q8 + _INT4,
    "mixtral int4 dense": ("flash_prefill", "ragged_decode_q8",
                           "moe_w4_matmul") + _INT4,
    "mixtral int4 dense top-8 control": ("flash_prefill", "ragged_decode_q8",
                                         "moe_w4_matmul") + _INT4,
}


def weight_recipe(params) -> str:
    """"int4", "int8" or "bf16": the width of a model's projections."""
    import torch

    w = params.layers[0]["wq"]
    if not hasattr(w, "q"):
        return "bf16"
    return "int4" if w.q.dtype == torch.uint8 else "int8"


def mixtral_ids(i, n, salt=0):
    """Request i's n prompt ids in Mixtral's vocabulary."""
    vocab = CFG_MIXTRAL["vocab_size"]
    return [(7 * i + 13 * j + salt) % (vocab - 1) + 1 for j in range(n)]


def mixtral_requests(salt):
    """Phase 4's prompt lengths and sampling in Mixtral's vocabulary:
    [(prompt ids, sampling)]."""
    return [(mixtral_ids(i, n, salt), sp)
            for i, (n, sp) in enumerate(REQUESTS)]


def mixtral_cases(records, requests, ids_fn=mixtral_ids):
    """The teacher-forced cases of a wave (its greedy requests: {label:
    (prompt, tokens, logprobs)}) and the planted fault: the last greedy
    request's tokens under another prompt of its length (`ids_fn`: the
    model's prompt ids)."""
    greedy = [r for r, (_, sp) in zip(records, requests)
              if sp.get("temperature") == 0.0]
    cases = {f"{len(ids)}-token": (ids, toks, lps)
             for ids, toks, lps in greedy}
    ids, toks, lps = greedy[-1]
    return cases, (ids_fn(99, len(ids), salt=99), toks, lps)


def mixtral_wave(label, eng, requests, phase="phase12"):
    """`requests` [(prompt ids, sampling)] submitted at once to an
    in-process engine and run to the end, with the plain versions' calls
    counted; every request must finish "length" at its budget. Returns
    (records, wall s, launches, graph counters gained, metrics before,
    after, plain calls)."""
    from localai_tpu_torch.engine.engine import GenRequest
    from localai_tpu_torch.ops.kernels import launch_counts
    from localai_tpu_torch.ops.sampling import SamplingParams

    before, g0, m0 = launch_counts(), eng.graphs.counters(), \
        dict(eng.metrics)
    t0 = time.perf_counter()
    with plain_calls() as plain:
        recs = []
        for ids, sp in requests:
            _, q = eng.submit(GenRequest(ids, SamplingParams(**sp),
                                         max_tokens=NEW_TOKENS,
                                         ignore_eos=True, logprobs=True))
            recs.append(dict(ids=ids, q=q, t0=time.perf_counter(),
                             ttft=None, toks=[], lps=[], text="",
                             last=None))
        while _pump(eng, recs):
            pass
    wall = time.perf_counter() - t0
    after = launch_counts()
    mixtral_finished(label, recs, phase)
    return (recs, wall, {k: after[k] - before[k] for k in after},
            graph_delta(g0, eng.graphs.counters()), m0, dict(eng.metrics),
            dict(plain))


def mixtral_finished(label, recs, phase="phase12"):
    """Every request of an in-process wave finished "length" at its
    budget."""
    for r in recs:
        if r["last"] is None or r["last"].finish_reason != "length" \
                or len(r["toks"]) != NEW_TOKENS:
            raise AssertionError(f"{phase} {label}: a request ended "
                                 f"{r['last'] and r['last'].finish_reason} "
                                 f"after {len(r['toks'])} tokens")


def leg_checks(phase, label, launched, graphs, plain, toks, cfg, forwards,
               logit_forwards, recipe):
    """Phases 12 and 13's checks of one leg's wave: every token in the
    vocabulary, the leg's kernels launched (LEG_OWN) and no plain version
    ran, no graph captured, and the weight GEMMs' counts: the recipe's
    projection kernel (w8a16_matmul, int8; w4a16_matmul, int4) once a
    projection a layer a forward (a Mixtral layer's four attention
    projections), its expert kernel (moe_w8_matmul, moe_w4_matmul) once an
    expert stack a layer a forward, its head kernel (head_matmul, or
    head_matmul_int4) once a forward with logits, and the other width's
    kernels never (bf16: only head_matmul)."""
    if not all(0 <= t < cfg.vocab_size for t in toks):
        raise AssertionError(f"{phase} {label}: token id out of vocab")
    for k in LEG_OWN[label]:
        if launched.get(k, 0) <= 0:
            raise AssertionError(f"{phase} {label}: {k} never launched")
    if plain:
        raise AssertionError(f"{phase} {label}: plain versions ran {plain}")
    caps = {p: c.get("captures", 0) for p, c in graphs.items()}
    if any(caps.values()):
        raise AssertionError(f"{phase} {label}: the wave captured graphs "
                             f"{caps}")
    check_weight_gemms(f"{phase} {label}", launched, cfg.num_layers,
                       forwards, logit_forwards, recipe == "int8",
                       moe=bool(cfg.num_experts), int4=recipe == "int4")


def mixtral_ragged(cfg, params, smi, label="int8 ragged", phase="phase12",
                   ids_fn=mixtral_ids, margin=ROUTE_MARGIN):
    """Phase 12's ragged leg on the weights the dense leg loaded (int8
    Mixtral; phase 13's int4 8B with ids_fn=prompt_ids, margin None): an
    in-process Engine on phase 6's pool (kv_pages=129, budget 192, int8
    KV) serves one wave of the four requests. Returns its row."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig

    t0 = time.perf_counter()
    eng = Engine(cfg, params, None, EngineConfig(**RAGGED_EC,
                                                 cache_type="int8"),
                 device="cuda")
    eng.warmup()
    setup_s = time.perf_counter() - t0
    requests = [(ids_fn(i, n, salt=1), sp)
                for i, (n, sp) in enumerate(REQUESTS)]
    marks = _replay_events(eng)
    recs, wall, launched, graphs, m0, m, plain = mixtral_wave(
        label, eng, requests, phase)
    del eng.graphs.run
    leg_checks(phase, label, launched, graphs, plain,
               [t for r in recs for t in r["toks"]], cfg,
               *forward_counts(m0, m, graphs), weight_recipe(params))
    if m["ragged_prefill_tokens"] - m0["ragged_prefill_tokens"] != sum(
            len(r["ids"]) for r in recs):
        raise AssertionError(f"{phase} {label}: not every prompt token was "
                             f"packed into a ragged tick")
    packs = m["ragged_dispatches"] - m0["ragged_dispatches"]
    check_fused_path(f"{phase} {label}", graphs, "rloop",
                     m["tokens_by_path__rloop"] - m0["tokens_by_path__rloop"],
                     launched, PAGED_OWN["int8"], cfg.num_layers,
                     m["decode_steps_dispatched"]
                     - m0["decode_steps_dispatched"] - packs)
    check_fused_path(f"{phase} {label} packs", {}, "rloop", 0, launched,
                     RAGGED_OWN["int8"], cfg.num_layers, packs)
    cases, fault = mixtral_cases(
        [(r["ids"], r["toks"], r["lps"]) for r in recs], requests, ids_fn)
    ref = check_reference(label, eng, cases, fault, phase=phase,
                          margin=margin)
    row = {"leg": label, "layers": cfg.num_layers, "tok_s":
           len(recs) * NEW_TOKENS / wall, "ttft_p50_ms": _p50_ms(recs),
           "busy_ms_step": _busy_ms_step(marks), "wall_s": wall,
           "engine_and_warmup_s": setup_s, "ragged_dispatches": packs,
           "graphs": graphs, "launches": {k: v for k, v in launched.items()
                                          if v},
           "reference_max_gap": max(v["max_gap"] for k, v in ref.items()
                                    if k != "planted fault"),
           "planted_fault_gap": ref["planted fault"]["max_gap"]}
    log(f"{phase} {label} " + json.dumps(row) + f" card {smi}")
    del eng
    return row


def mixtral_control(cfg, params, smi, label="int8 dense top-8 control",
                    phase="phase12"):
    """Phase 12's control leg on the int8 weights: the same model with
    every expert routed (experts_per_tok = E: the router's softmax weights
    the experts continuously, so a bf16-level difference cannot pick
    another expert) in an in-process dense Engine (int8 KV), the wave's
    greedy requests, each held to the teacher-forced reference at phase
    5-11's REF_MARGIN. The same kernels launch as on the top-2 path.
    Returns its row."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig

    cfg8 = dataclasses.replace(cfg, experts_per_tok=cfg.num_experts)
    eng = Engine(cfg8, params, None, EngineConfig(
        max_slots=4, max_context=2048, cache_type="int8"), device="cuda")
    eng.warmup()
    requests = [r for r in mixtral_requests(salt=3)
                if r[1].get("temperature") == 0.0]
    recs, wall, launched, graphs, m0, m, plain = mixtral_wave(
        label, eng, requests, phase)
    leg_checks(phase, label, launched, graphs, plain,
               [t for r in recs for t in r["toks"]], cfg8,
               *forward_counts(m0, m, graphs), weight_recipe(params))
    cases, fault = mixtral_cases(
        [(r["ids"], r["toks"], r["lps"]) for r in recs], requests)
    ref = check_reference(label, eng, cases, fault, phase=phase)
    row = {"leg": label, "layers": cfg.num_layers, "tok_s":
           len(recs) * NEW_TOKENS / wall, "ttft_p50_ms": _p50_ms(recs),
           "busy_ms_step": None, "wall_s": wall,
           "launches": {k: v for k, v in launched.items() if v},
           "reference_max_gap": max(v["max_gap"] for k, v in ref.items()
                                    if k != "planted fault"),
           "planted_fault_gap": ref["planted fault"]["max_gap"]}
    log(f"{phase} {label} " + json.dumps(row) + f" card {smi}")
    del eng
    return row


def mixtral_grpc(label, d, load_kw, requests, smi, then=None,
                 phase="phase12", ids_fn=mixtral_ids, margin=ROUTE_MARGIN):
    """One gRPC leg of phase 12 (or 13): LoadModel on the checkpoint at
    `d` (the default dense engine), one wave of `requests`, its checks and
    the teacher-forced reference on the card (`ids_fn`: the model's
    prompt ids, for the planted fault; `margin`: the reference's bar, None
    for phases 5-11's); then(engine), if given, with the model still
    loaded. Returns the leg's row."""
    marks, row = {}, {}

    def on_load(servicer):
        marks["m"] = _replay_events(servicer.engine)

    def after(client, servicer, out):
        eng = servicer.engine
        served_plain = dict(plain)
        del eng.graphs.run
        res = out["_results"]
        leg_checks(phase, label, out["launches_during_requests"],
                   out["graphs"], served_plain,
                   [t for r in res for t in r[1]], eng.cfg,
                   out["forwards"], out["logit_forwards"],
                   weight_recipe(eng.params))
        check_fused_path(f"{phase} {label}", out["graphs"], "dense",
                         out["loop_tokens"], out["launches_during_requests"],
                         LEG_OWN[label][1:2], eng.cfg.num_layers,
                         out["decode_steps"])
        cases, fault = mixtral_cases([(r[4], r[1], r[2]) for r in res],
                                     requests, ids_fn)
        ref = check_reference(label, eng, cases, fault, phase=phase,
                              margin=margin)
        row.update({
            "leg": label, "layers": eng.cfg.num_layers,
            "tok_s": out["tok_s"], "ttft_p50_ms": out["ttft_p50_ms"],
            "busy_ms_step": _busy_ms_step(marks["m"]),
            "wall_s": out["wall_s"], "peak_mem_gb": out["peak_mem_gb"],
            "graphs": out["graphs"],
            "launches": {k: v for k, v in
                         out["launches_during_requests"].items() if v},
            "reference_max_gap": max(v["max_gap"] for k, v in ref.items()
                                     if k != "planted fault"),
            "planted_fault_gap": ref["planted fault"]["max_gap"]})
        if weight_recipe(eng.params) == "int4":
            row.update(int4_weight_bytes(eng.cfg, eng.params))
        log(f"{phase} {label} " + json.dumps(row) + f" card {smi}")
        if then is not None:
            then(eng)

    with plain_calls() as plain:
        serve_recipe(label, d, load_kw, phase=phase, waves=[requests],
                     then=after, on_load=on_load)
    return row


def phase_mixtral(smi):
    """Phase 12, Mixtral-8x7B at its published widths: synthetic
    checkpoints (MixtralForCausalLM, random weights from the loader's
    seed). The int8 recipe (int8 weights and KV) at full depth through the
    gRPC backend's LoadModel on the dense engine, four requests, then an
    in-process ragged Engine on the same weights, one wave, and the top-8
    control leg (mixtral_control); bf16 at 16 of its 32 layers (93 GB of
    bf16 weights exceed the card), one dense request. Returns the phase's
    launch counts."""
    import gc
    import tempfile

    import torch

    from localai_tpu_torch.ops.kernels import launch_counts, \
        reset_launch_counts

    os.environ["LOCALAI_ALLOW_SYNTHETIC"] = "1"
    t0 = time.perf_counter()
    reset_launch_counts()
    rows = []
    int8_kw = dict(dtype="int8", cache_type_key="int8",
                   cache_type_value="int8")
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(dict(CFG_MIXTRAL, localai_synthetic=True), f)
        torch.cuda.reset_peak_memory_stats()
        rows.append(mixtral_grpc(
            "int8 dense", d, int8_kw, mixtral_requests(salt=0), smi,
            then=lambda eng: rows.extend([
                mixtral_ragged(eng.cfg, eng.params, smi),
                mixtral_control(eng.cfg, eng.params, smi)])))
        gc.collect()
        torch.cuda.empty_cache()
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(dict(CFG_MIXTRAL, localai_synthetic=True,
                           num_hidden_layers=MIXTRAL_BF16_LAYERS), f)
        torch.cuda.reset_peak_memory_stats()
        rows.append(mixtral_grpc(
            "bf16 dense", d, dict(dtype="bfloat16"),
            mixtral_requests(salt=2)[MIXTRAL_BF16_REQUEST:
                                     MIXTRAL_BF16_REQUEST + 1], smi))
    gc.collect()
    torch.cuda.empty_cache()
    counts = launch_counts()
    log("phase12 summary " + json.dumps({
        r["leg"]: {k: r[k] for k in ("layers", "tok_s", "ttft_p50_ms",
                                     "busy_ms_step", "reference_max_gap",
                                     "planted_fault_gap")} for r in rows})
        + f" launches {json.dumps({k: v for k, v in counts.items() if v})}"
        + f" ({time.perf_counter() - t0:.1f} s) card {smi}")
    return counts


# ----------------------------------------------------------------- phase 13

# the int4 recipe (int4 weights, bf16 activations) with int8 KV
INT4_KW = dict(dtype="int4", cache_type_key="int8", cache_type_value="int8")


def int4_weight_bytes(cfg, params):
    """The int4 projections' and head's q bytes against the
    architecture's K x N elements (a Mixtral layer's expert stacks E x K x
    N): int4 holds half a byte an element, the int8 recipe a byte.
    Raises unless every projection is packed int4 at exactly K x N / 2
    bytes."""
    import torch

    h, hd, inter = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    q_out, kv_out = cfg.num_heads * hd, cfg.num_kv_heads * hd
    shapes = {"wq": h * q_out, "wk": h * kv_out, "wv": h * kv_out,
              "wo": q_out * h}
    if cfg.num_experts:
        shapes.update({k: cfg.num_experts * h * inter
                       for k in EXPERT_STACKS})
    else:
        shapes.update(w_gate=h * inter, w_up=h * inter, w_down=inter * h)
    elements = cfg.num_layers * sum(shapes.values()) + h * cfg.vocab_size
    stored = 0
    for w in [layer[n] for layer in params.layers for n in shapes] + [
            params.lm_head]:
        if w.q.dtype != torch.uint8:
            raise AssertionError(f"phase13: a projection is {w.q.dtype}, "
                                 f"not packed int4")
        stored += w.q.numel()
    if 2 * stored != elements:
        raise AssertionError(f"phase13: {stored} int4 bytes for {elements} "
                             f"weight elements (want half a byte each)")
    return {"int4_weight_bytes": stored, "int8_recipe_weight_bytes": elements,
            "int4_over_int8": stored / elements}


def phase_int4(smi):
    """Phase 13, the int4 recipe at full width (int4 weights, int8 KV):
    the synthetic Llama-3.1-8B at its 32 layers through the gRPC backend's
    LoadModel(dtype="int4") on the default dense engine, phase 4's four
    requests, then an in-process ragged Engine of phase 6's shape on the
    same weights, one wave; then Mixtral-8x7B at its 32 layers (22.5 GB of
    int4 experts) through LoadModel, phase 12's four requests, and its
    top-8 control leg. Checks (leg_checks, check_fused_path,
    check_reference, int4_weight_bytes): every stream to its budget; the
    int4 weight kernels launched, no int8 one and no plain version; no
    graph captured in a wave; each greedy stream against the
    teacher-forced plain forward (0.25 logit; Mixtral's top-2 legs
    ROUTE_MARGIN beside the top-8 control at 0.25), whose planted fault
    fails; the projections hold K x N / 2 bytes. Returns the phase's
    launch counts."""
    import gc
    import tempfile

    import torch

    from localai_tpu_torch.ops.kernels import launch_counts, \
        reset_launch_counts

    os.environ["LOCALAI_ALLOW_SYNTHETIC"] = "1"
    t0 = time.perf_counter()
    reset_launch_counts()
    rows = []
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(dict(CFG_8B, localai_synthetic=True), f)
        torch.cuda.reset_peak_memory_stats()
        rows.append(mixtral_grpc(
            "8b int4 dense", d, INT4_KW, REQUESTS, smi, phase="phase13",
            ids_fn=prompt_ids, margin=None,
            then=lambda eng: rows.append(mixtral_ragged(
                eng.cfg, eng.params, smi, label="8b int4 ragged",
                phase="phase13", ids_fn=prompt_ids, margin=None))))
        gc.collect()
        torch.cuda.empty_cache()
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(dict(CFG_MIXTRAL, localai_synthetic=True), f)
        torch.cuda.reset_peak_memory_stats()
        rows.append(mixtral_grpc(
            "mixtral int4 dense", d, INT4_KW, mixtral_requests(salt=4), smi,
            phase="phase13", then=lambda eng: rows.append(mixtral_control(
                eng.cfg, eng.params, smi,
                label="mixtral int4 dense top-8 control", phase="phase13"))))
    gc.collect()
    torch.cuda.empty_cache()
    counts = launch_counts()
    log("phase13 summary " + json.dumps({
        r["leg"]: {k: r.get(k) for k in (
            "layers", "tok_s", "ttft_p50_ms", "busy_ms_step",
            "reference_max_gap", "planted_fault_gap", "int4_weight_bytes",
            "int8_recipe_weight_bytes")} for r in rows})
        + " (before the int4 expert GEMM's decode redesign, PERF.md §5:"
        " busy ms a decode step, the 8B dense 10.66-10.70, ragged"
        " 8.37-8.41, Mixtral dense 23.68-24.90)"
        + f" launches {json.dumps({k: v for k, v in counts.items() if v})}"
        + f" ({time.perf_counter() - t0:.1f} s) card {smi}")
    return counts


# ----------------------------------------------------------------- phase 14

TP = 2
# four streams: three greedy (the teacher-forced check's) and one seeded
TP_REQUESTS = [(17, dict(temperature=0.0)), (300, dict(temperature=0.0)),
               (700, dict(temperature=0.0)),
               (40, dict(temperature=0.8, top_k=40, seed=11))]
# layers a leg serves: 8 of the published 32 (at 32 every leg the phase
# took about nine minutes of the smoke's 1200 s, 230-340 ms a decode step;
# the ragged legs served 32 until phase 15 joined the smoke, which then
# took 1010.6 s on a slow host: PERF.md); new tokens a stream
TP_LAYERS = {"dense": 8, "paged": 8, "ragged": 8}
TP_TOKENS = 32
TP_LOAD = {"dense": dict(parallel=4, context_size=2048),
           "paged": dict(parallel=4, context_size=4096, kv_pages=129)}
TP_RECIPES = (("bf16", dict(dtype="bfloat16"), "bfloat16", ""),
              ("int8", dict(dtype="int8", cache_type_key="int8",
                            cache_type_value="int8"), "int8", "int8"))
# the six TP wrappers (row 12): (its launch counter, the CUDA source, the
# reference's wrapper, the unsharded kernel it launches per shard)
SHARDED = {
    "paged_scatter_append_sharded": (
        "localai_tpu_torch/csrc/paged_scatter.cu",
        "localai_tpu/ops/pallas/paged_scatter.py:141",
        "paged_scatter_append"),
    "paged_scatter_append_q8_sharded": (
        "localai_tpu_torch/csrc/paged_scatter.cu",
        "localai_tpu/ops/pallas/paged_scatter.py:183",
        "paged_scatter_append_q8"),
    "ragged_paged_attention_sharded": (
        "localai_tpu_torch/csrc/ragged_attention.cu",
        "localai_tpu/ops/pallas/ragged_attention.py:436",
        "ragged_paged_attention"),
    "ragged_paged_attention_q8_sharded": (
        "localai_tpu_torch/csrc/ragged_attention.cu",
        "localai_tpu/ops/pallas/ragged_attention.py:458",
        "ragged_paged_attention_q8"),
    "ragged_scatter_append_sharded": (
        "localai_tpu_torch/csrc/paged_scatter.cu",
        "localai_tpu/ops/pallas/ragged_attention.py:541",
        "ragged_scatter_append"),
    "ragged_scatter_append_q8_sharded": (
        "localai_tpu_torch/csrc/paged_scatter.cu",
        "localai_tpu/ops/pallas/ragged_attention.py:555",
        "ragged_scatter_append_q8"),
}
# the rank's own kernels a TP leg must launch (rank 0's counts)
TP_OWN = {
    ("dense", "bf16"): ("flash_prefill", "ragged_decode"),
    ("dense", "int8"): ("flash_prefill", "ragged_decode_q8",
                        "w8a16_matmul"),
    ("paged", "bf16"): ("ragged_decode_paged",
                        "paged_scatter_append_sharded"),
    ("paged", "int8"): ("ragged_decode_q8_paged",
                        "paged_scatter_append_q8_sharded", "w8a16_matmul"),
    ("ragged", "bf16"): ("ragged_paged_attention_sharded",
                         "ragged_scatter_append_sharded",
                         "ragged_decode_paged",
                         "paged_scatter_append_sharded"),
    ("ragged", "int8"): ("ragged_paged_attention_q8_sharded",
                         "ragged_scatter_append_q8_sharded",
                         "ragged_decode_q8_paged",
                         "paged_scatter_append_q8_sharded", "w8a16_matmul"),
}


def _rank_mesh(r):
    """Rank r of the TP-wide model axis, for a check that runs one shard's
    kernels in this process (no process group: no collective)."""
    import torch

    from localai_tpu_torch.parallel.mesh import Mesh

    return Mesh(rank=r, model=TP, device=torch.device("cuda"))


def _head_shard(t, r, dim=1):
    """Rank r's contiguous head shard of `t` (its own storage)."""
    n = t.shape[dim] // TP
    return t.narrow(dim, r * n, n).contiguous()


def _joined(shards, i, swap=False):
    """The ranks' i-th tensors joined on the head axis (swap: in the wrong
    rank order, the planted fault)."""
    import torch

    parts = [s[i] for s in shards]
    return torch.cat(parts[::-1] if swap else parts, dim=1)


def _sharded_timings(name, fn, plain, unsharded, library, nbytes, flops,
                     peak):
    """The row-12 readings of one wrapper at rank 0's shard: device, host
    and in-graph ms, its plain version's and the unsharded kernel's (all
    KV heads, one rank's work before TP) ms, the library call's, and
    bound_ms from the shard's bytes and operations."""
    from localai_tpu_torch.ops.kernels import launch_counts

    before = launch_counts()[name]
    fn()
    if launch_counts()[name] != before + 1:
        raise AssertionError(f"{name}: one call did not count one launch")
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(
        ms=_time_ms(fn), ms_host=_time_ms(fn, spin=False),
        ms_graph=_graph_ms(fn), plain_ms=_time_ms(plain),
        unsharded_ms=_time_ms(unsharded),
        library_ms=None if library is None else _time_ms(library),
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        bound_formula=(f"max({nbytes:.4g} B of the shard / 3.35 TB/s, "
                       f"{flops:.4g} flop / {peak / 1e12:.0f} TFLOP/s)"))


def tp_paged_scatter(q8):
    """paged_scatter_append[_q8]_sharded on each rank's head shard of phase
    2's pool (8 slots, 129 blocks, KVH 8: 4 a rank), joined: the unsharded
    plain version's pools over the whole pool, BIT FOR BIT; the shards
    joined in the wrong rank order (the planted fault) differ."""
    import torch

    from localai_tpu_torch.ops import kernels as K
    from localai_tpu_torch.ops.kvcache import quantize_tokens

    B, KVH, D, maxb = 8, 8, 128, 32
    lengths = [(97 * b + 1) % (maxb * 128 - 1) for b in range(B)]
    k, v, table, nb = _paged_pools(B, KVH, D, [n + 1 for n in lengths],
                                   maxb, seed=2, nb=129)
    g = torch.Generator(device="cuda").manual_seed(3)
    bf16 = torch.bfloat16
    k_new = torch.randn(B, KVH, D, device="cuda", generator=g).to(bf16)
    v_new = torch.randn(B, KVH, D, device="cuda", generator=g).to(bf16)
    pos = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    active = torch.tensor([b % 3 != 2 for b in range(B)], device="cuda")
    targets = K.paged_targets(pos, table, active)
    if q8:
        kq, ks = quantize_tokens(k)
        vq, vs = quantize_tokens(v)
        pools = [kq, ks.reshape(nb, KVH, 1, 128), vq,
                 vs.reshape(nb, KVH, 1, 128)]
        name, plain_fn = ("paged_scatter_append_q8_sharded",
                          K.paged_scatter_append_q8_plain)
        wrapper, unsharded = (K.paged_scatter_append_q8_sharded,
                              K.paged_scatter_append_q8)
    else:
        pools = [k.to(bf16), v.to(bf16)]
        name, plain_fn = ("paged_scatter_append_sharded",
                          K.paged_scatter_append_plain)
        wrapper, unsharded = (K.paged_scatter_append_sharded,
                              K.paged_scatter_append)
    ref = [t.clone() for t in pools]
    plain_fn(*ref, k_new, v_new, pos, table, active, targets=targets)
    shards = [[_head_shard(p, r) for p in pools] for r in range(TP)]
    new = [(_head_shard(k_new, r), _head_shard(v_new, r)) for r in range(TP)]
    for r in range(TP):
        wrapper(_rank_mesh(r), *shards[r], *new[r], pos, table, active,
                targets=targets)
    torch.cuda.synchronize()
    for i, want in enumerate(ref):
        if not torch.equal(_joined(shards, i), want):
            raise AssertionError(f"{name}: shard {i} joined differs from "
                                 f"the unsharded plain version")
    if all(torch.equal(_joined(shards, i, swap=True), want)
           for i, want in enumerate(ref)):
        raise AssertionError(f"{name}: the check does not reject the "
                             f"planted fault")
    kvh = KVH // TP
    es, out_es = 2, 1 if q8 else 2
    nbytes = (2 * B * kvh * D * es + 8 * B + 2 * B * kvh * D * out_es
              + (2 * B * kvh * 4 if q8 else 0))
    mine, (kn, vn), m0 = shards[0], new[0], _rank_mesh(0)
    plain_pools = [t.clone() for t in mine]
    full = [t.clone() for t in pools]
    library = None
    if not q8:
        pb, off = (t.long() for t in targets)

        def library():
            mine[0][pb, :, off] = kn
            mine[1][pb, :, off] = vn
    res = {"max_abs_err": 0.0, "tol": "bit-exact", "shape": (
        f"bf16 B={B} NB={nb} KVH={KVH} ({kvh} a rank) D={D}"),
        "planted_fault_differs": True}
    res.update(_sharded_timings(
        name, lambda: wrapper(m0, *mine, kn, vn, pos, table, active,
                              targets=targets),
        lambda: plain_fn(*plain_pools, kn, vn, pos, table, active,
                         targets=targets),
        lambda: unsharded(*full, k_new, v_new, pos, table, active,
                          targets=targets),
        library, nbytes, 0.0, PEAK_BF16))
    log(f"phase14 {name} " + json.dumps(res))
    return name, res


def _pack_work(seqs, window=None):
    """(live query-key pairs, K/V rows read, table entries) of a ragged
    pack, as check_ragged_attention counts them."""
    pairs = kv_read = entries = 0
    for kvl, ql in (x for x in seqs if x is not None):
        first = kvl - ql
        lo = max(first - window + 1, 0) if window else 0
        kv_read += kvl - lo
        entries += -(-kvl // 128) - lo // 128
        pairs += sum(min(p + 1, window or p + 1) for p in range(first, kvl))
    return pairs, kv_read, entries


def tp_ragged_attention(q8):
    """ragged_paged_attention[_q8]_sharded at phase 6's pack (T = 192, H
    32 on KVH 8: 16 on 4 a rank), each rank on its query heads and KV-head
    shard, joined on the head axis: the unsharded plain version's live rows
    within rows 8/9's bf16 tolerance; the shards joined in the wrong rank
    order (the planted fault) rejected."""
    import torch

    from localai_tpu_torch.ops import kernels as K
    from localai_tpu_torch.ops.kvcache import quantize_tokens

    H, KVH, D = 32, 8, 128
    seqs = _ragged_seqs(RAGGED_DECODE, RAGGED_CHUNK)
    k, v, meta, live, _, nb = _ragged_pack(None, None, 32, 129, KVH, D,
                                           seed=4, seqs=seqs)
    T = int(meta["block_seq"].shape[0]) * 8
    g = torch.Generator(device="cuda").manual_seed(5)
    bf16 = torch.bfloat16
    q = torch.randn(T, H, D, device="cuda", generator=g).to(bf16)
    if q8:
        kq, ks = quantize_tokens(k)
        vq, vs = quantize_tokens(v)
        pools = [kq, ks.reshape(nb, KVH, 1, 128), vq,
                 vs.reshape(nb, KVH, 1, 128)]
        name, plain_fn = ("ragged_paged_attention_q8_sharded",
                          K.ragged_paged_attention_q8_plain)
        wrapper, unsharded = (K.ragged_paged_attention_q8_sharded,
                              K.ragged_paged_attention_q8)
    else:
        pools = [k.to(bf16), v.to(bf16)]
        name, plain_fn = ("ragged_paged_attention_sharded",
                          K.ragged_paged_attention_plain)
        wrapper, unsharded = (K.ragged_paged_attention_sharded,
                              K.ragged_paged_attention)
    ref = plain_fn(q, *pools, **meta)
    shards = [[_head_shard(q, r)] + [_head_shard(p, r) for p in pools]
              for r in range(TP)]
    outs = [[wrapper(_rank_mesh(r), *shards[r], **meta)] for r in range(TP)]
    torch.cuda.synchronize()
    rows = torch.tensor(live, device="cuda")
    res = _check_close(f"phase14 {name}", _joined(outs, 0)[rows], ref[rows],
                       TOL["bfloat16"],
                       fault=_joined(outs, 0, swap=True)[rows])
    pairs, kv_read, entries = _pack_work(seqs)
    h, kvh, kv_es = H // TP, KVH // TP, 1 if q8 else 2
    nbytes = (kv_read * kvh * D * 2 * kv_es
              + (kv_read * kvh * 2 * 4 if q8 else 0)
              + 2 * len(live) * h * D * 2 + 4 * entries)
    mine, m0 = shards[0], _rank_mesh(0)
    res["shape"] = (f"bf16 T={T} H={H} ({h} a rank) KVH={KVH} ({kvh} a "
                    f"rank) D={D} MAXB=32 NB={nb}")
    res.update(_sharded_timings(
        name, lambda: wrapper(m0, *mine, **meta),
        lambda: plain_fn(*mine, **meta), lambda: unsharded(q, *pools, **meta),
        None, nbytes, 4.0 * pairs * h * D, PEAK_BF16))
    log(f"phase14 {name} " + json.dumps(res))
    return name, res


def tp_ragged_scatter(q8):
    """ragged_scatter_append[_q8]_sharded at phase 6's pack's own targets
    on each rank's head shard, joined: the unsharded plain version's pools
    outside the trash block 0, BIT FOR BIT; the shards joined in the wrong
    rank order (the planted fault) differ."""
    import torch

    from localai_tpu_torch.models.llama import ragged_row_targets
    from localai_tpu_torch.ops import kernels as K
    from localai_tpu_torch.ops.kvcache import quantize_tokens

    KVH, D = 8, 128
    k, v, meta, live, _, nb = _ragged_pack(RAGGED_DECODE, RAGGED_CHUNK, 32,
                                           129, KVH, D, seed=6)
    T = int(meta["block_seq"].shape[0]) * 8
    _, pb, off = ragged_row_targets(meta["block_seq"], meta["qstart"],
                                    meta["qlen"], meta["kvlen"],
                                    meta["tables"], 32 * 128)
    g = torch.Generator(device="cuda").manual_seed(7)
    bf16 = torch.bfloat16
    k_new = torch.randn(T, KVH, D, device="cuda", generator=g).to(bf16)
    v_new = torch.randn(T, KVH, D, device="cuda", generator=g).to(bf16)
    if q8:
        kq, ks = quantize_tokens(k)
        vq, vs = quantize_tokens(v)
        pools = [kq, ks.reshape(nb, KVH, 1, 128), vq,
                 vs.reshape(nb, KVH, 1, 128)]
        name, plain_fn = ("ragged_scatter_append_q8_sharded",
                          K.ragged_scatter_append_q8_plain)
        wrapper, unsharded = (K.ragged_scatter_append_q8_sharded,
                              K.ragged_scatter_append_q8)
    else:
        pools = [k.to(bf16), v.to(bf16)]
        name, plain_fn = ("ragged_scatter_append_sharded",
                          K.ragged_scatter_append_plain)
        wrapper, unsharded = (K.ragged_scatter_append_sharded,
                              K.ragged_scatter_append)
    ref = [t.clone() for t in pools]
    plain_fn(*ref, k_new, v_new, pb, off)
    shards = [[_head_shard(p, r) for p in pools] for r in range(TP)]
    new = [(_head_shard(k_new, r), _head_shard(v_new, r)) for r in range(TP)]
    for r in range(TP):
        wrapper(_rank_mesh(r), *shards[r], *new[r], pb, off)
    torch.cuda.synchronize()
    for i, want in enumerate(ref):
        if not torch.equal(_joined(shards, i)[1:], want[1:]):
            raise AssertionError(f"{name}: shard {i} joined differs from "
                                 f"the unsharded plain version outside "
                                 f"block 0")
    if all(torch.equal(_joined(shards, i, swap=True)[1:], want[1:])
           for i, want in enumerate(ref)):
        raise AssertionError(f"{name}: the check does not reject the "
                             f"planted fault")
    n, kvh = len(live), KVH // TP
    out_es = 1 if q8 else 2
    nbytes = (2 * n * kvh * D * 2 + 8 * n + 2 * n * kvh * D * out_es
              + (2 * n * kvh * 4 if q8 else 0))
    mine, (kn, vn), m0 = shards[0], new[0], _rank_mesh(0)
    plain_pools = [t.clone() for t in mine]
    full = [t.clone() for t in pools]
    library = None
    if not q8:
        pbl, offl = pb.long(), off.long()

        def library():
            mine[0][pbl, :, offl] = kn
            mine[1][pbl, :, offl] = vn
    res = {"max_abs_err": 0.0, "tol": "bit-exact outside block 0",
           "shape": f"bf16 T={T} NB={nb} KVH={KVH} ({kvh} a rank) D={D}",
           "planted_fault_differs": True}
    res.update(_sharded_timings(
        name, lambda: wrapper(m0, *mine, kn, vn, pb, off),
        lambda: plain_fn(*plain_pools, kn, vn, pb, off),
        lambda: unsharded(*full, k_new, v_new, pb, off), library, nbytes,
        0.0, PEAK_BF16))
    log(f"phase14 {name} " + json.dumps(res))
    return name, res


def tp_kernels():
    """Row 12: each *_sharded wrapper on two head shards of a whole pool on
    the card, joined and held against the unsharded plain version, and
    timed at rank 0's shard (tp = 2: 4 of the 8B's 8 KV heads)."""
    return dict(fn(q8) for q8 in (False, True) for fn in (
        tp_paged_scatter, tp_ragged_attention, tp_ragged_scatter))


class _CollectiveClock:
    """Rank 0's host ms inside its mesh's collectives: each call waits for
    the card first (torch.cuda.synchronize), so the clock holds the
    collective's own time (gloo: the copies to and from the host, the
    transfer, the wait for the other rank), not the kernels queued before
    it."""

    def __init__(self, mesh):
        import torch

        self.ms, self.calls = 0.0, 0
        for name in ("all_reduce", "all_gather"):
            orig = getattr(mesh, name)

            def timed(*a, _orig=orig, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = _orig(*a, **kw)
                self.ms += (time.perf_counter() - t) * 1e3
                self.calls += 1
                return out

            setattr(mesh, name, timed)

    def read(self):
        return self.ms, self.calls


def _busy_ms(p):
    """Device ms of rank 0 in a torch.profiler window: the union of its
    CUDA activities' intervals (kernels and copies; overlapping streams
    counted once), read from the profiler's raw events (key_averages over
    a leg's hundred thousand events took tens of seconds)."""
    from torch.autograd import DeviceType

    spans = sorted((e.start_ns(), e.end_ns())
                   for e in p.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e6


def _tp_reference(cfg, params, kv):
    """The one-rank engine-like holder check_reference teacher-forces
    with: the whole model's params on the card, the recipe's KV kind and
    the rope tables."""
    from localai_tpu_torch.ops.rope import rope_table

    cos, sin = rope_table(cfg.rope, 4096, device="cuda")
    return SimpleNamespace(cfg=cfg, device=params.embed.device,
                           params=params, ec=SimpleNamespace(cache_type=kv),
                           _cos=cos, _sin=sin)


def _followers(label, out, codes, outputs):
    """Hold a leg's followers to a clean exit: exit code 0 and no
    traceback in their output; note each one's own launch counts (the
    worker role prints them when rank 0 stops it)."""
    launches = []
    for text in outputs:
        lines = [ln for ln in text.splitlines() if " launches " in ln]
        launches.append(json.loads(lines[-1].split(" launches ", 1)[1])
                        if lines else None)
    out["follower_exit"] = codes
    out["follower_launches"] = launches
    log(f"phase14 {label} followers exit {codes} launches "
        + json.dumps(launches))
    if codes != [0] * (TP - 1) or len(outputs) != TP - 1:
        raise AssertionError(f"phase14 {label}: followers exited {codes}")
    for text in outputs:
        if "Traceback" in text:
            raise AssertionError(f"phase14 {label}: a follower raised:\n"
                                 + text[-3000:])


def _tp_readings(label, path, recs, wall, m0, m1, clock, busy, launched,
                 smi):
    """One leg's line: tok/s, TTFT p50, rank 0's busy and idle ms a decode
    step (its profiler's device time against the wall a step; the card
    also runs rank 1's kernels) and its collectives' ms a decode step."""
    import statistics

    steps = m1["decode_steps_dispatched"] - m0["decode_steps_dispatched"]
    toks = m1["tokens_generated"] - m0["tokens_generated"]
    coll_ms, calls = clock
    out = {"path": path, "tok_s": toks / wall, "wall_s": wall,
           "ttft_p50_ms": statistics.median(r[0] for r in recs) * 1e3,
           "decode_steps": steps, "tokens": toks,
           "collectives_ms_per_step": coll_ms / max(steps, 1),
           "collective_calls": calls,
           "busy_ms_per_step": busy / max(steps, 1),
           "idle_ms_per_step": (wall * 1e3 - busy) / max(steps, 1),
           "launches": {k: v for k, v in launched.items() if v},
           "card": smi}
    log(f"phase14 {label} " + json.dumps(out))
    return out


def _tp_check_leg(label, path, recipe, launched, recs, ref):
    """A leg's checks: every stream to its budget, the rank's own kernels
    launched (the recipe's, through the sharded wrappers), the other
    recipe's not, and the greedy streams held against the one-rank
    teacher-forced reference within REF_MARGIN, whose planted fault (a
    stream held to another prompt) fails."""
    for i, r in enumerate(recs):
        if len(r[1]) != TP_TOKENS:
            raise AssertionError(f"phase14 {label} request {i}: "
                                 f"{len(r[1])} tokens")
    for k in TP_OWN[path, recipe]:
        if launched.get(k, 0) <= 0:
            raise AssertionError(f"phase14 {label}: {k} never launched")
    if recipe == "bf16" and launched.get("w8a16_matmul"):
        raise AssertionError(f"phase14 {label}: an int8 GEMM launched")
    unsharded = ("paged_scatter_append", "paged_scatter_append_q8",
                 "ragged_paged_attention", "ragged_paged_attention_q8",
                 "ragged_scatter_append", "ragged_scatter_append_q8")
    for k in unsharded:
        if launched.get(k):
            raise AssertionError(f"phase14 {label}: the unsharded {k} "
                                 f"launched on a mesh")
    cases = {f"{len(r[4])}-token": (r[4], r[1], r[2]) for r in recs[:3]}
    fault = (prompt_ids(99, len(recs[2][4]), salt=99), recs[2][1],
             recs[2][2])
    return check_reference(label, ref, cases, fault, phase="phase14")


def tp_grpc_leg(label, path, recipe, d, load_kw, ref, smi):
    """A dense or paged leg: the port's gRPC backend in this process as
    rank 0 with LoadModel(mesh_model=2) (one follower process on the same
    card), TP_REQUESTS at once, under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from localai_tpu_torch.backend.server import serve
    from localai_tpu_torch.ops.kernels import launch_counts

    server, servicer, port = serve("127.0.0.1:0", device="cuda")
    client = _Client(f"127.0.0.1:{port}")
    try:
        t0 = time.perf_counter()
        r = client.load(model=d, mesh_model=TP, **TP_LOAD[path], **load_kw)
        if not r.success:
            raise RuntimeError(f"phase14 {label}: LoadModel failed: "
                               f"{r.message}")
        servicer.engine.warmup()
        log(f"phase14 {label}: LoadModel (two ranks) + warmup "
            f"{time.perf_counter() - t0:.1f} s")
        eng = servicer.engine
        clock = _CollectiveClock(eng.mesh)
        before, m0 = launch_counts(), dict(eng.metrics)
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            recs, wall = drive_requests(client, requests=TP_REQUESTS,
                                        tokens=TP_TOKENS)
            torch.cuda.synchronize()
        m1 = dict(eng.metrics)
        launched = {k: v - before[k] for k, v in launch_counts().items()}
        out = _tp_readings(label, path, recs, wall, m0, m1, clock.read(),
                           _busy_ms(p), launched, smi)
        out["eager"] = eng.graphs.counters()
        out["reference"] = _tp_check_leg(label, path, recipe, launched,
                                         recs, ref)
    finally:
        client.close()
        codes = servicer.free()
        server.stop(grace=1).wait(10)
    _followers(label, out, codes, servicer.follower_output)
    return out


def tp_ragged_leg(label, recipe, d, dtype, kv, ref, smi):
    """A ragged leg: the worker role's world led by this process (one
    follower process on the same card) under an Engine of phase 6's shape
    (ragged_token_budget 192, the fused ragged loop), TP_REQUESTS at once,
    under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from localai_tpu_torch.core.worker import World, engine_fields
    from localai_tpu_torch.engine.engine import (
        Engine, EngineConfig, GenRequest,
    )
    from localai_tpu_torch.engine.loader import load_config, load_params
    from localai_tpu_torch.ops.kernels import launch_counts
    from localai_tpu_torch.ops.sampling import SamplingParams

    t0 = time.perf_counter()
    world = World(d, dtype, TP, "cuda")
    eng = None
    try:
        cfg = load_config(d, dtype=dtype)
        params = load_params(d, cfg, dtype=dtype, device=world.mesh.device,
                             mesh=world.mesh)
        ec = EngineConfig(**RAGGED_EC, cache_type=kv, mesh=world.mesh,
                          replicator=world.replicator)
        eng = Engine(cfg, params, None, ec, device=world.mesh.device)
        world.replicator.wait_for_followers()
        world.replicator.broadcast("engine", engine_fields(ec))
        eng.warmup()
        log(f"phase14 {label}: two-rank world + weights + warmup "
            f"{time.perf_counter() - t0:.1f} s")
        clock = _CollectiveClock(world.mesh)
        before, m0 = launch_counts(), dict(eng.metrics)
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            t1 = time.perf_counter()
            subs = []
            for i, (n, sp) in enumerate(TP_REQUESTS):
                ids = prompt_ids(i, n)
                subs.append((ids, time.perf_counter(), eng.submit(GenRequest(
                    ids, SamplingParams(**sp), max_tokens=TP_TOKENS,
                    ignore_eos=True, logprobs=True))[1]))
            # (ttft s, tokens, logprobs, None, prompt ids) a request, as
            # drive_requests returns them; a token's time is the end of the
            # engine step that streamed it
            recs = [[None, [], [], None, ids] for ids, _, _ in subs]
            busy = True
            while busy:
                busy = eng.step()
                now = time.perf_counter()
                for rec, (_, ts, q) in zip(recs, subs):
                    while not q.empty():
                        o = q.get_nowait()
                        if o.token_id >= 0:
                            rec[0] = rec[0] or now - ts
                            rec[1].append(o.token_id)
                            rec[2].append(o.logprob)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        m1 = dict(eng.metrics)
        launched = {k: v - before[k] for k, v in launch_counts().items()}
        out = _tp_readings(label, "ragged", recs, wall, m0, m1, clock.read(),
                           _busy_ms(p), launched, smi)
        out["eager"] = eng.graphs.counters()
        out["ragged_dispatches"] = m1["ragged_dispatches"] - \
            m0["ragged_dispatches"]
        out["reference"] = _tp_check_leg(label, "ragged", recipe, launched,
                                         recs, ref)
    finally:
        if eng is not None:
            eng.stop()
        codes = world.close()
    _followers(label, out, codes, world.outputs)
    return out


def phase_tp(smi):
    """Tensor parallelism on one card: row 12's wrappers against the
    unsharded plain versions, then the synthetic Llama-3.1-8B served by two
    ranks over gloo on cuda:0 (the smoke as rank 0, one follower process),
    dense and paged through LoadModel(mesh_model=2), ragged through the
    worker role's world, bf16 then the int8 recipe; each leg's greedy
    streams teacher-forced through the one-rank model on the same weights.
    Returns (rank 0's launch counts over the legs, row 12's readings)."""
    import gc
    import tempfile

    import torch

    from localai_tpu_torch.engine.loader import load_config, load_params
    from localai_tpu_torch.ops.kernels import launch_counts, \
        reset_launch_counts

    # the follower is another process on this card: hand it the memory
    # this process's allocator still caches from earlier phases
    gc.collect()
    torch.cuda.empty_cache()
    kernels = tp_kernels()
    os.environ["LOCALAI_ALLOW_SYNTHETIC"] = "1"
    prewarm = os.environ.get("LOCALAI_NO_PREWARM")
    os.environ["LOCALAI_NO_PREWARM"] = "1"
    legs = {}
    t0 = time.perf_counter()
    reset_launch_counts()
    try:
        with tempfile.TemporaryDirectory() as top:
            dirs = {}
            for n in sorted(set(TP_LAYERS.values())):
                dirs[n] = os.path.join(top, f"l{n}")
                os.makedirs(dirs[n])
                with open(os.path.join(dirs[n], "config.json"), "w") as f:
                    json.dump(dict(CFG_8B, num_hidden_layers=n,
                                   localai_synthetic=True), f)
            for recipe, load_kw, dtype, kv in TP_RECIPES:
                refs = {}
                for path in ("dense", "paged", "ragged"):
                    n = TP_LAYERS[path]
                    if n not in refs:
                        cfg = load_config(dirs[n], dtype=dtype)
                        refs[n] = _tp_reference(cfg, load_params(
                            dirs[n], cfg, dtype=dtype, device="cuda"), kv)
                    label = f"{recipe} {path} ({n} layers)"
                    if path == "ragged":
                        legs[label] = tp_ragged_leg(label, recipe, dirs[n],
                                                    dtype, kv, refs[n], smi)
                    else:
                        legs[label] = tp_grpc_leg(label, path, recipe,
                                                  dirs[n], load_kw, refs[n],
                                                  smi)
                del refs
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        if prewarm is None:
            os.environ.pop("LOCALAI_NO_PREWARM", None)
        else:
            os.environ["LOCALAI_NO_PREWARM"] = prewarm
    counts = launch_counts()
    for name in SHARDED:
        if counts[name] <= 0:
            raise AssertionError(f"phase14: {name} never launched on a leg")
    log("phase14 summary " + json.dumps({
        label: {k: leg[k] for k in (
            "tok_s", "ttft_p50_ms", "collectives_ms_per_step",
            "busy_ms_per_step", "idle_ms_per_step")}
        | {"max_gap": max(r["max_gap"] for c, r in leg["reference"].items()
                          if c != "planted fault")}
        for label, leg in legs.items()})
        + f" rank-0 launches {json.dumps({k: v for k, v in counts.items() if v})}"
        + f" wall {time.perf_counter() - t0:.1f} s card {smi}")
    return counts, kernels


# ----------------------------------------------------------------- phase 15

# BAAI/bge-large-en-v1.5's published config (BertModel)
CFG_BGE_LARGE = {
    "architectures": ["BertModel"], "model_type": "bert",
    "vocab_size": 30522, "hidden_size": 1024, "intermediate_size": 4096,
    "num_hidden_layers": 24, "num_attention_heads": 16,
    "max_position_embeddings": 512, "type_vocab_size": 2,
    "layer_norm_eps": 1e-12, "hidden_act": "gelu",
}

# llava-hf/llava-1.5-7b-hf's published config: the text side (Vicuna-7B,
# Llama-2-7B's widths, the vocabulary widened to 32064 by the image token
# and padding) written out in full, and the CLIP ViT-L/14-336 tower
CFG_LLAVA = {
    "architectures": ["LlavaForConditionalGeneration"],
    "model_type": "llava", "image_token_index": 32000,
    "vision_feature_layer": -2, "vision_feature_select_strategy": "default",
    "projector_hidden_act": "gelu",
    "text_config": {
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "vocab_size": 32064, "hidden_size": 4096,
        "intermediate_size": 11008, "num_hidden_layers": 32,
        "num_attention_heads": 32, "num_key_value_heads": 32,
        "max_position_embeddings": 4096, "rms_norm_eps": 1e-5,
        "rope_theta": 10000.0, "tie_word_embeddings": False},
    "vision_config": {
        "model_type": "clip_vision_model", "hidden_size": 1024,
        "intermediate_size": 4096, "num_hidden_layers": 24,
        "num_attention_heads": 16, "image_size": 336, "patch_size": 14,
        "layer_norm_eps": 1e-5, "projection_dim": 768},
}

# the embeddings leg: one Embedding request a bucket of the Embedder's
# (64, 256, 1024), a batch of eight in the 1024 bucket, and one 32-token
# query against eight documents of 64-400 tokens (the 1024 bucket: M =
# 8 x 1024 = 8192 rows through the head)
ROLES_BUCKETS = [64, 256, 1024]
ROLES_EMBED_LENS = (17, 200, 900)
ROLES_BATCH = [1024 - 47 * i for i in range(8)]
ROLES_QUERY = 32
ROLES_DOCS = (64, 110, 160, 210, 260, 310, 360, 400)
# the embeddings legs' name of the scorer's call (its head at M = 8192)
SCORER_CALL = "score 8 docs (M = 8192)"
# pooled vectors against the plain forward: cosine; rerank scores (mean
# log-probs, magnitude ~12 at V = 128256): absolute, and the order wherever
# two plain scores are more than ORDER_GAP apart
COS_MIN = 0.999
SCORE_TOL = 0.05
ORDER_GAP = 0.1
BERT_LENS = (17, 200, 500)
BERT_BATCH = 8
# llava: ~40 text tokens around one image placeholder a prompt, 32 new
# tokens a stream; four streams, the fourth seeded-sampled
LLAVA_TEXT = 40
LLAVA_TOKENS = 32
LLAVA_SAMPLING = [dict(temperature=0.0)] * 3 + [
    dict(temperature=0.8, top_k=40, seed=15)]
ROLES_OWN = {"bf16": ("flash_prefill", "head_matmul"),
             "int8": ("flash_prefill", "w8a16_matmul", "head_matmul")}


def write_safetensors(path, tensors):
    """{name: tensor} (bf16 or f32, any device) → a safetensors file: the
    8-byte header length, the JSON header, the raw little-endian bytes."""
    import torch

    code = {torch.bfloat16: "BF16", torch.float32: "F32"}
    header, offset = {}, 0
    for k, t in tensors.items():
        n = t.numel() * t.element_size()
        header[k] = {"dtype": code[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for t in tensors.values():
            f.write(t.detach().contiguous().reshape(-1).view(
                torch.uint8).cpu().numpy().tobytes())


class _Seeded:
    """bf16 tensors on the card from one seeded generator: linear weights
    N(0, 1/fan_in) (fan_in: the last axis unless given), LayerNorm gains
    near 1 and biases near 0."""

    def __init__(self, seed):
        import torch

        self.torch = torch
        self.g = torch.Generator(device="cuda").manual_seed(seed)

    def _n(self, shape):
        return self.torch.randn(shape, generator=self.g, device="cuda")

    def w(self, *shape, fan=None):
        return (self._n(shape) * (fan or shape[-1]) ** -0.5).to(
            self.torch.bfloat16)

    def bias(self, n):
        return (0.02 * self._n((n,))).to(self.torch.bfloat16)

    def gain(self, n):
        return (1.0 + 0.1 * self._n((n,))).to(self.torch.bfloat16)


def bert_checkpoint(d, seed=15):
    """bge-large-en-v1.5's widths with weights from `seed`, written as a
    BertModel safetensors file (bf16) with write_tokenizer's tokenizer of
    its vocabulary. Returns the seconds it took."""
    t0 = time.perf_counter()
    c, r = CFG_BGE_LARGE, _Seeded(seed)
    h, inter = c["hidden_size"], c["intermediate_size"]
    t = {"embeddings.word_embeddings.weight": r.w(c["vocab_size"], h),
         "embeddings.position_embeddings.weight": r.w(
             c["max_position_embeddings"], h),
         "embeddings.token_type_embeddings.weight": r.w(
             c["type_vocab_size"], h),
         "embeddings.LayerNorm.weight": r.gain(h),
         "embeddings.LayerNorm.bias": r.bias(h)}
    for i in range(c["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        for name, o, n in (("attention.self.query", h, h),
                           ("attention.self.key", h, h),
                           ("attention.self.value", h, h),
                           ("attention.output.dense", h, h),
                           ("intermediate.dense", inter, h),
                           ("output.dense", h, inter)):
            t[p + name + ".weight"] = r.w(o, n)
            t[p + name + ".bias"] = r.bias(o)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            t[p + name + ".weight"] = r.gain(h)
            t[p + name + ".bias"] = r.bias(h)
    write_safetensors(os.path.join(d, "model.safetensors"), t)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(c, f)
    write_tokenizer(d, c["vocab_size"])
    return time.perf_counter() - t0


def llava_checkpoint(d, seed=16):
    """A synthetic llava-1.5-7b directory: config.json (CFG_LLAVA,
    "localai_synthetic": the text side drawn from the seed by the loader)
    and a safetensors file holding only the CLIP tower and the projector
    (classic layout, bf16, about 0.32 B values) from `seed`. Returns (the
    values written, seconds)."""
    t0 = time.perf_counter()
    vc, r = CFG_LLAVA["vision_config"], _Seeded(seed)
    h, inter = vc["hidden_size"], vc["intermediate_size"]
    p_sz = vc["patch_size"]
    n_pos = (vc["image_size"] // p_sz) ** 2 + 1
    pre = "vision_tower.vision_model."
    t = {pre + "embeddings.patch_embedding.weight": r.w(
             h, 3, p_sz, p_sz, fan=3 * p_sz * p_sz),
         pre + "embeddings.class_embedding": r.w(h),
         pre + "embeddings.position_embedding.weight": r.w(n_pos, h),
         pre + "pre_layrnorm.weight": r.gain(h),
         pre + "pre_layrnorm.bias": r.bias(h)}
    for i in range(vc["num_hidden_layers"]):
        p = pre + f"encoder.layers.{i}."
        for name, o, n in (("self_attn.q_proj", h, h),
                           ("self_attn.k_proj", h, h),
                           ("self_attn.v_proj", h, h),
                           ("self_attn.out_proj", h, h),
                           ("mlp.fc1", inter, h), ("mlp.fc2", h, inter)):
            t[p + name + ".weight"] = r.w(o, n)
            t[p + name + ".bias"] = r.bias(o)
        for name in ("layer_norm1", "layer_norm2"):
            t[p + name + ".weight"] = r.gain(h)
            t[p + name + ".bias"] = r.bias(h)
    ht = CFG_LLAVA["text_config"]["hidden_size"]
    t["multi_modal_projector.linear_1.weight"] = r.w(ht, h)
    t["multi_modal_projector.linear_1.bias"] = r.bias(ht)
    t["multi_modal_projector.linear_2.weight"] = r.w(ht, ht)
    t["multi_modal_projector.linear_2.bias"] = r.bias(ht)
    write_safetensors(os.path.join(d, "model.safetensors"), t)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(dict(CFG_LLAVA, localai_synthetic=True), f)
    return sum(x.numel() for x in t.values()), time.perf_counter() - t0


@contextlib.contextmanager
def plain_forwards():
    """Within: the cacheless forwards and the prefill attend through
    flash_prefill's plain version, and the weight GEMMs run theirs
    (plain_weight_gemms) — the embeddings leg's reference, on the card."""
    from localai_tpu_torch.models import llama
    from localai_tpu_torch.ops import kernels

    saved = llama.flash_prefill
    llama.flash_prefill = kernels.flash_prefill_plain
    try:
        with plain_weight_gemms():
            yield
    finally:
        llama.flash_prefill = saved


def _call_ms(fn):
    """(fn's result, its wall ms, its device-busy ms): one call timed on
    the host clock (the card synchronized before and after), then a second
    call under torch.profiler, whose CUDA activities' union is the busy
    ms (_busy_ms). Both calls are the path's own."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    return out, wall, _busy_ms(p)


def _cos(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _order_flips(got, want, gap=ORDER_GAP):
    """Pairs (i, j) whose plain scores are more than `gap` apart and whose
    served scores order them the other way."""
    n = len(want)
    return [(i, j) for i in range(n) for j in range(n)
            if want[i] - want[j] > gap and not got[i] > got[j]]


def roles_embed_leg(label, d, load_kw, smi):
    """The embeddings and rerank roles of the synthetic Llama-3.1-8B (32
    layers) over gRPC: LoadModel(embeddings=true) (no prewarm: the roles
    do not use the engine), Embedding at ROLES_EMBED_LENS (one bucket
    each), the Embedder on a batch of eight in the 1024 bucket, the
    CrossScorer on a 32-token query and eight documents, the batched
    `prompts` Embedding and Rerank through the tokenizer. Checks: no plain
    version ran; flash_prefill launched 32 times a forward, w8a16_matmul
    (int8) 7 x 32 a forward, head_matmul once a scorer forward; cosine >=
    COS_MIN against the same calls with every kernel's plain version on
    the card, scores within SCORE_TOL and in the plain order wherever two
    differ by more than ORDER_GAP; gRPC Rerank and batched prompts equal
    the in-process calls on the tokenized text. Returns the leg's row."""
    import numpy as np
    import torch

    from localai_tpu_torch.backend.server import serve
    from localai_tpu_torch.ops.kernels import launch_counts

    os.environ["LOCALAI_NO_PREWARM"] = "1"
    server, servicer, port = serve("127.0.0.1:0", device="cuda")
    client = _Client(f"127.0.0.1:{port}")
    row = {"leg": label}
    try:
        t0 = time.perf_counter()
        r = client.load(model=d, embeddings=True, parallel=1,
                        context_size=2048, prefill_buckets=ROLES_BUCKETS,
                        **load_kw)
        if not r.success:
            raise RuntimeError(f"phase15 {label}: LoadModel failed: "
                               f"{r.message}")
        row["load_s"] = time.perf_counter() - t0
        cfg, emb, scorer = servicer.cfg, servicer.embedder, servicer.scorer
        L = cfg.num_layers
        calls, forwards, scored = {}, 0, 0
        before = launch_counts()
        with plain_calls() as plain:
            served = {}
            for n in ROLES_EMBED_LENS:
                ids = prompt_ids(n, n, salt=15)
                res, wall, busy = _call_ms(
                    lambda ids=ids: client.embedding(prompt_ids=ids))
                if res.prompt_tokens != n or len(res.embeddings) != \
                        cfg.hidden_size:
                    raise AssertionError(f"phase15 {label}: Embedding of "
                                         f"{n} ids answered {res}")
                served[n] = (ids, np.asarray(res.embeddings, np.float32))
                calls[f"embedding {n}"] = (wall, busy)
                forwards += 2
            batch = [prompt_ids(i, n, salt=16)
                     for i, n in enumerate(ROLES_BATCH)]
            bvecs, wall, busy = _call_ms(lambda: emb.embed(batch))
            calls["embed batch 8 x 1024"] = (wall, busy)
            forwards += 2
            q = prompt_ids(0, ROLES_QUERY, salt=17)
            docs = [prompt_ids(i + 1, n, salt=18)
                    for i, n in enumerate(ROLES_DOCS)]
            scores, wall, busy = _call_ms(lambda: scorer.score(q, docs))
            calls[SCORER_CALL] = (wall, busy)
            forwards += 2
            scored += 2
            texts = ["what is the weather in paris today",
                     "a cat sat on the mat", '{"unit": "celsius"}']
            t = time.perf_counter()
            res = client.embedding(prompts=texts)
            calls["embedding prompts x3"] = ((time.perf_counter() - t)
                                             * 1e3, None)
            forwards += 1
            want = emb.embed([servicer.tok.encode(x) for x in texts])
            forwards += 1
            got = np.asarray([v.values for v in res.vectors], np.float32)
            if got.shape != want.shape or np.abs(got - want).max() > 1e-6:
                raise AssertionError(f"phase15 {label}: batched prompts "
                                     f"differ from the Embedder's vectors")
            t = time.perf_counter()
            rr = client.rerank(query=texts[0], documents=texts + [
                "paris weather: rain, 12 celsius"], top_n=3)
            calls["rerank 4 docs"] = ((time.perf_counter() - t) * 1e3, None)
            forwards += 1
            scored += 1
            want = scorer.score(
                servicer.tok.encode(texts[0]),
                [servicer.tok.encode(x, add_bos=False)
                 for x in texts + ["paris weather: rain, 12 celsius"]])
            forwards += 1
            scored += 1
            order = [int(i) for i in want.argsort()[::-1][:3]]
            if [x.index for x in rr.results] != order or max(
                    abs(x.relevance_score - want[x.index])
                    for x in rr.results) > 1e-5:
                raise AssertionError(f"phase15 {label}: Rerank {rr} against "
                                     f"the scorer's {want}")
        launched = {k: v - before[k] for k, v in launch_counts().items()}
        if plain:
            raise AssertionError(f"phase15 {label}: plain versions ran "
                                 f"{plain}")
        int8 = load_kw.get("dtype") == "int8"
        # the scorer's head: M = documents x bucket, at least 4 x 64 rows,
        # above head_plan's SIMT rows: a bf16 head splits x32 first
        want = {"flash_prefill": L * forwards,
                "w8a16_matmul": 7 * L * forwards if int8 else 0,
                "head_matmul": scored,
                "split_bf16_terms": 0 if int8 else scored}
        for k, n in want.items():
            if launched[k] != n:
                raise AssertionError(f"phase15 {label}: {k} launched "
                                     f"{launched[k]} times, not {n}")
        others = {k: v for k, v in launched.items() if v and k not in want}
        if others:
            raise AssertionError(f"phase15 {label}: other kernels launched "
                                 f"{others}")
        # the same calls with every kernel's plain version, on the card
        mark = launch_counts()
        with plain_forwards():
            ref = {n: emb.embed([ids])[0] for n, (ids, _) in served.items()}
            ref_batch = emb.embed(batch)
            ref_scores = scorer.score(q, docs)
        if launch_counts() != mark:
            raise AssertionError(f"phase15 {label}: the plain forward "
                                 f"launched a kernel")
        cosines = {n: _cos(v, ref[n]) for n, (_, v) in served.items()}
        cosines["batch min"] = min(_cos(a, b)
                                   for a, b in zip(bvecs, ref_batch))
        dscore = float(np.abs(scores - ref_scores).max())
        flips = _order_flips(scores, ref_scores)
        row.update({
            "layers": L, "recipe": weight_recipe(servicer.engine.params),
            "calls_wall_busy_ms": calls, "cosine": cosines,
            "scores": [float(x) for x in scores],
            "plain_scores": [float(x) for x in ref_scores],
            "max_dscore": dscore, "order_flips": flips,
            "launches": {k: v for k, v in launched.items() if v},
            "forwards": forwards,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
        log(f"phase15 {label} " + json.dumps(row) + f" card {smi}")
        if min(cosines.values()) < COS_MIN or dscore > SCORE_TOL or flips:
            raise AssertionError(f"phase15 {label}: served against plain: "
                                 f"cosines {cosines}, scores {dscore}, "
                                 f"order flips {flips}")
        return row
    finally:
        os.environ.pop("LOCALAI_NO_PREWARM", None)
        client.close()
        servicer.shutdown()
        server.stop(grace=1).wait(10)
        import gc

        gc.collect()
        torch.cuda.empty_cache()


def roles_bert_leg(d, smi):
    """bge-large-en-v1.5's widths (24 layers, hidden 1024, 16 heads) over
    gRPC: LoadModel on its directory (the encoder alone, f32), Embedding
    at BERT_LENS and of three texts (`prompts`), TokenizeString, and the
    BertEmbedder on a batch of eight at 512; each held to the port on the
    CPU (the same file, f32): cosine >= COS_MIN. No kernel launches (BERT
    attends both ways: plain matmuls). Returns the leg's row."""
    import numpy as np
    import torch

    from localai_tpu_torch.backend.server import serve
    from localai_tpu_torch.models import bert
    from localai_tpu_torch.ops.kernels import launch_counts

    server, servicer, port = serve("127.0.0.1:0", device="cuda")
    client = _Client(f"127.0.0.1:{port}")
    row = {"leg": "bert"}
    try:
        t0 = time.perf_counter()
        r = client.load(model=d)
        if not r.success:
            raise RuntimeError(f"phase15 bert: LoadModel failed {r.message}")
        row["load_s"] = time.perf_counter() - t0
        if servicer.engine is not None or not isinstance(
                servicer.embedder, bert.BertEmbedder):
            raise AssertionError("phase15 bert: not an embedding-only load")
        vocab = CFG_BGE_LARGE["vocab_size"]
        before = launch_counts()
        calls, served = {}, {}
        for n in BERT_LENS:
            ids = [(7 * n + 13 * j) % (vocab - 1) + 1 for j in range(n)]
            res, wall, busy = _call_ms(
                lambda ids=ids: client.embedding(prompt_ids=ids))
            served[n] = (ids, np.asarray(res.embeddings, np.float32))
            calls[f"embedding {n}"] = (wall, busy)
        batch = [[(11 * i + 5 * j) % (vocab - 1) + 1 for j in range(512)]
                 for i in range(BERT_BATCH)]
        bvecs, wall, busy = _call_ms(lambda: servicer.embedder.embed(batch))
        calls[f"embed batch {BERT_BATCH} x 512"] = (wall, busy)
        texts = ["what is the weather in paris today",
                 "a cat sat on the mat"]
        tok = client.tokenize(texts[0])
        pres = client.embedding(prompts=texts)
        if list(tok.tokens) != servicer.tok.encode(texts[0]) or \
                len(pres.vectors) != 2:
            raise AssertionError("phase15 bert: TokenizeString or batched "
                                 "prompts answered wrong")
        if launch_counts() != before:
            raise AssertionError("phase15 bert: a kernel launched")
        t0 = time.perf_counter()
        cfg = bert.load_bert_config(d)
        cpu = bert.BertEmbedder(cfg, bert.load_bert_params(d, cfg,
                                                           device="cpu"),
                                device="cpu")
        ref = {n: cpu.embed([ids])[0] for n, (ids, _) in served.items()}
        ref_batch = cpu.embed(batch)
        ref_prompts = cpu.embed([servicer.tok.encode(x) for x in texts])
        cpu_s = time.perf_counter() - t0
        cosines = {n: _cos(v, ref[n]) for n, (_, v) in served.items()}
        cosines["batch min"] = min(_cos(a, b)
                                   for a, b in zip(bvecs, ref_batch))
        cosines["prompts min"] = min(
            _cos(v.values, b) for v, b in zip(pres.vectors, ref_prompts))
        row.update({"layers": cfg.num_layers, "dtype": cfg.dtype,
                    "calls_wall_busy_ms": calls, "cosine": cosines,
                    "cpu_reference_s": cpu_s})
        log("phase15 bert " + json.dumps(row) + f" card {smi}")
        if min(cosines.values()) < COS_MIN:
            raise AssertionError(f"phase15 bert: card against CPU {cosines}")
        return row
    finally:
        client.close()
        servicer.shutdown()
        server.stop(grace=1).wait(10)
        import gc

        gc.collect()
        torch.cuda.empty_cache()


def _png_b64(seed, size=(400, 300)):
    """A PNG of seeded random pixels, base64 (the proto's images entry)."""
    import base64
    import io

    import numpy as np
    from PIL import Image

    px = np.random.default_rng(seed).integers(
        0, 256, (size[1], size[0], 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(px, "RGB").save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def llava_prompts(salt=0):
    """Four prompts of LLAVA_TEXT text ids in llava's vocabulary, the
    image placeholder (32000) at position 5, and each its PNG."""
    img = CFG_LLAVA["image_token_index"]
    out = []
    for i in range(len(LLAVA_SAMPLING)):
        ids = [(7 * i + 13 * j + salt) % (img - 1) + 1
               for j in range(LLAVA_TEXT)]
        ids[5] = img
        out.append((ids, _png_b64(100 + i + salt)))
    return out


def _tower_ms(vision, images):
    """Device ms of encode_images (tower + projector) on `images` (PNG
    base64), by CUDA events (median of 5 after a warm call)."""
    import numpy as np

    from localai_tpu_torch.models.llava import (
        decode_image_b64, encode_images, preprocess_image,
    )

    vcfg, vparams, meta = vision
    px = np.concatenate([preprocess_image(decode_image_b64(b), vcfg)
                         for b in images])
    return _time_ms(lambda: encode_images(vparams, vcfg, meta, px), reps=5,
                    warm=1, spin=False)


def _mm_records(recs, label):
    """Every stream of an mm wave finished "length" at LLAVA_TOKENS."""
    for r in recs:
        if r["last"] is None or r["last"].finish_reason != "length" \
                or len(r["toks"]) != LLAVA_TOKENS:
            raise AssertionError(f"phase15 {label}: a stream ended "
                                 f"{r['last'] and r['last'].finish_reason} "
                                 f"after {len(r['toks'])} tokens")


def _mm_reference(label, eng, recs, requests, mm):
    """The teacher-forced check of a wave's greedy mm streams, the same
    image rows fed to the plain forward; planted fault: the last greedy
    stream held to its prompt without the image rows."""
    greedy = [(i, r) for i, r in enumerate(recs)
              if requests[i][1].get("temperature") == 0.0]
    cases = {f"stream {i}": (r["ids"], r["toks"], r["lps"])
             for i, r in greedy}
    rows = {f"stream {i}": mm[i] for i, _ in greedy}
    i, r = greedy[-1]
    ref = check_reference(label, eng, cases, (r["ids"], r["toks"], r["lps"]),
                          phase="phase15", mm=rows)
    return (max(v["max_gap"] for k, v in ref.items() if k != "planted fault"),
            ref["planted fault"]["max_gap"])


def llava_grpc_leg(d, smi, out):
    """llava's dense leg over gRPC at all 32 layers (bf16): LoadModel on
    the llava directory (the engine, the tower and the projector), four
    PredictStream requests with one PNG each (~40 text tokens, the
    placeholder expanded to 576 image rows: 615-token prompts, which
    prefill by chunked extend with the feature rows injected), 32 new
    tokens. Checks: every stream to its budget, no plain version ran, the
    dense decode kernel once a layer a decode step, the three greedy
    streams within 0.25 logit of the teacher-forced plain forward fed the
    same rows (planted fault: no image rows). Keeps the vision params and
    the expanded prompts in `out`. Returns the leg's row."""
    import threading

    import torch

    from localai_tpu_torch.backend.server import serve
    from localai_tpu_torch.ops.kernels import launch_counts

    server, servicer, port = serve("127.0.0.1:0", device="cuda")
    client = _Client(f"127.0.0.1:{port}")
    try:
        t0 = time.perf_counter()
        r = client.load(model=d, dtype="bfloat16", parallel=4,
                        context_size=2048)
        if not r.success:
            raise RuntimeError(f"phase15 llava: LoadModel failed {r.message}")
        load_s = time.perf_counter() - t0
        eng = servicer.engine
        prompts = llava_prompts()
        recs = [None] * len(prompts)

        def one(i, ids, b64, sp):
            ts = time.perf_counter()
            rec = dict(ttft=None, toks=[], lps=[], last=None)
            for c in client.stream(prompt_ids=ids, images=[b64],
                                   tokens=LLAVA_TOKENS, ignore_eos=True,
                                   logprobs=True, **sp):
                if c.token_ids and rec["ttft"] is None:
                    rec["ttft"] = time.perf_counter() - ts
                rec["toks"] += list(c.token_ids)
                rec["lps"] += list(c.logprobs)
                rec["last"] = c
            recs[i] = rec

        m0, g0, before = client.metrics(), eng.graphs.counters(), \
            launch_counts()
        t0 = time.perf_counter()
        with plain_calls() as plain:
            threads = [threading.Thread(target=one, args=(i, ids, b64, sp))
                       for i, ((ids, b64), sp) in enumerate(
                           zip(prompts, LLAVA_SAMPLING))]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        wall = time.perf_counter() - t0
        launched = {k: v - before[k] for k, v in launch_counts().items()}
        m1, graphs = client.metrics(), graph_delta(g0,
                                                   eng.graphs.counters())
        if plain:
            raise AssertionError(f"phase15 llava: plain versions ran {plain}")
        mm = []
        for (ids, b64), rec in zip(prompts, recs):
            if rec is None:
                raise RuntimeError("phase15 llava: a stream failed")
            ids_x, feats, pos = servicer._encode_images(ids, [b64])
            rec["ids"] = ids_x
            mm.append((feats, pos))
        _mm_records(recs, "llava dense")
        steps = int(m1["decode_steps_dispatched"]
                    - m0["decode_steps_dispatched"])
        check_fused_path("phase15 llava dense", graphs, "dense",
                         m1["tokens_by_path__loop"]
                         - m0["tokens_by_path__loop"], launched,
                         ("ragged_decode",), eng.cfg.num_layers, steps)
        chunks = int(m1["prefill_chunks_mid"] - m0["prefill_chunks_mid"]
                     + m1["prefill_chunks_final"]
                     - m0["prefill_chunks_final"])
        if chunks < len(prompts) * 2:
            raise AssertionError(f"phase15 llava: {chunks} prefill chunks "
                                 f"for {len(prompts)} 615-token prompts")
        gap, fault_gap = _mm_reference("llava dense", eng, recs,
                                       list(zip(prompts, LLAVA_SAMPLING)),
                                       mm)
        tower_1 = _tower_ms(servicer.vision, [prompts[0][1]])
        tower_4 = _tower_ms(servicer.vision, [b for _, b in prompts])
        import statistics

        row = {"leg": "llava dense grpc", "layers": eng.cfg.num_layers,
               "prompt_tokens": [len(r["ids"]) for r in recs],
               "load_s": load_s, "wall_s": wall,
               "tok_s": len(recs) * LLAVA_TOKENS / wall,
               "ttft_p50_ms": statistics.median(r["ttft"] for r in recs)
               * 1e3, "prefill_chunks": chunks, "graphs": graphs,
               "tower_ms_per_image": {"1 image": tower_1,
                                      "4 images": tower_4 / 4},
               "launches": {k: v for k, v in launched.items() if v},
               "reference_max_gap": gap, "planted_fault_gap": fault_gap}
        log("phase15 llava dense grpc " + json.dumps(row) + f" card {smi}")
        out["vision"] = servicer.vision
        out["mm"] = [(r["ids"], feats, pos)
                     for r, (feats, pos) in zip(recs, mm)]
        return row
    finally:
        client.close()
        servicer.shutdown()
        server.stop(grace=1).wait(10)
        import gc

        gc.collect()
        torch.cuda.empty_cache()


def llava_engine_leg(label, cfg, params, ec, mm, smi, own):
    """An in-process Engine (SERVE_LAYERS) on llava's text side serving
    the four mm requests of the gRPC leg (their expanded prompts and image
    rows) at once. Checks: every stream to its budget, no plain version
    ran, each kernel of `own` launched, on a ragged engine every prompt
    token packed; the greedy streams against the teacher-forced plain
    forward fed the same rows. Returns the leg's row."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig, \
        GenRequest
    from localai_tpu_torch.ops.kernels import launch_counts
    from localai_tpu_torch.ops.sampling import SamplingParams

    eng = Engine(cfg, params, None, EngineConfig(**ec), device="cuda")
    eng.warmup()
    m0, g0, before = dict(eng.metrics), eng.graphs.counters(), \
        launch_counts()
    t0 = time.perf_counter()
    with plain_calls() as plain:
        recs = []
        for (ids, feats, pos), sp in zip(mm, LLAVA_SAMPLING):
            _, q = eng.submit(GenRequest(
                list(ids), SamplingParams(**sp), max_tokens=LLAVA_TOKENS,
                ignore_eos=True, logprobs=True, mm_embeds=feats,
                mm_positions=pos))
            recs.append(dict(ids=list(ids), q=q, t0=time.perf_counter(),
                             ttft=None, toks=[], lps=[], text="", last=None))
        while _pump(eng, recs):
            pass
    wall = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    m, graphs = dict(eng.metrics), graph_delta(g0, eng.graphs.counters())
    _mm_records(recs, label)
    if plain:
        raise AssertionError(f"phase15 {label}: plain versions ran {plain}")
    for k in own:
        if launched[k] <= 0:
            raise AssertionError(f"phase15 {label}: {k} never launched")
    if ec.get("ragged_token_budget") and (
            m["ragged_prefill_tokens"] - m0["ragged_prefill_tokens"]
            != sum(len(r["ids"]) for r in recs)):
        raise AssertionError(f"phase15 {label}: not every prompt token "
                             f"was packed into a ragged tick")
    gap, fault_gap = _mm_reference(
        label, eng, recs, [(None, sp) for sp in LLAVA_SAMPLING],
        [(f, p) for _, f, p in mm])
    row = {"leg": label, "layers": cfg.num_layers, "wall_s": wall,
           "tok_s": len(recs) * LLAVA_TOKENS / wall,
           "ttft_p50_ms": _p50_ms(recs), "graphs": graphs,
           "ragged_dispatches": int(m.get("ragged_dispatches", 0)
                                    - m0.get("ragged_dispatches", 0)),
           "launches": {k: v for k, v in launched.items() if v},
           "reference_max_gap": gap, "planted_fault_gap": fault_gap}
    log(f"phase15 {label} " + json.dumps(row) + f" card {smi}")
    del eng
    return row


def llava_identity_leg(cfg, params, mm, smi):
    """The inject lane as an identity on the card: a dense Engine
    (SERVE_LAYERS, int8 KV, single-shot prefill of the 615-token prompts)
    serves each greedy prompt alone three times — as tokens, with the
    embedding rows of its own tokens injected at the image positions, and
    with the image rows — and the first two give the same tokens (the
    reference's test_llava identity idea); the image rows give others.
    Returns the leg's row."""
    import numpy as np
    import torch

    from localai_tpu_torch.engine.engine import Engine, EngineConfig, \
        GenRequest
    from localai_tpu_torch.ops.kernels import launch_counts
    from localai_tpu_torch.ops.sampling import SamplingParams

    eng = Engine(cfg, params, None, EngineConfig(
        max_slots=2, max_context=2048, prefill_buckets=(1024,),
        prefill_chunk=1024, cache_type="int8"), device="cuda")
    eng.warmup()
    before = launch_counts()

    def run(ids, rows=None):
        kw = {} if rows is None else dict(mm_embeds=rows[0],
                                          mm_positions=rows[1])
        _, q = eng.submit(GenRequest(list(ids), SamplingParams(
            temperature=0.0), max_tokens=LLAVA_TOKENS, ignore_eos=True,
            **kw))
        rec = dict(q=q, t0=time.perf_counter(), ttft=None, toks=[], lps=[],
                   text="", last=None)
        while _pump(eng, [rec]):
            pass
        return rec["toks"]

    out = []
    with plain_calls() as plain:
        for ids, feats, pos in mm[:2]:
            own = eng.params.embed[torch.as_tensor(
                np.asarray(ids)[pos], device="cuda")].float().cpu().numpy()
            toks, same, image = run(ids), run(ids, (own, pos)), run(
                ids, (feats, pos))
            out.append((toks == same, toks != image))
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    if plain:
        raise AssertionError(f"phase15 identity: plain versions ran {plain}")
    for k in ("flash_prefill", "ragged_decode_q8"):
        if launched[k] <= 0:
            raise AssertionError(f"phase15 identity: {k} never launched")
    row = {"leg": "llava identity", "layers": cfg.num_layers,
           "own_rows_equal_tokens": [a for a, _ in out],
           "image_rows_differ": [b for _, b in out],
           "launches": {k: v for k, v in launched.items() if v}}
    log("phase15 llava identity " + json.dumps(row) + f" card {smi}")
    if not all(a for a, _ in out) or not all(b for _, b in out):
        raise AssertionError(f"phase15 identity: {row}")
    del eng
    return row


def row14_large_m(smi, M=8192, K=4096, V=128256):
    """Row 14 (head_matmul on a bf16 head) at the scorer's M = 8 x 1024,
    on the route head_plan takes there (logged; the tensor cores on x32's
    three bf16 terms), against its plain version (the head's f32 copy and
    torch.matmul, which is also the library call) with the planted fault
    x32 rounded to bf16, device ms (median of 3 after a warm call, behind
    a spin) and both bounds: bound_ms the tensor cores' three bf16 passes
    (3 x 2MKV at 989 TFLOP/s, or the bytes), bound_f32_ms 2MKV at the f32
    FMAs' 67 TFLOP/s (the SIMT route's bound)."""
    import torch

    from localai_tpu_torch.ops.kernels import head_matmul, \
        head_matmul_plain, launch_counts
    from localai_tpu_torch.ops.kernels import weight_gemm as wg

    g = torch.Generator(device="cuda").manual_seed(14)
    x32 = torch.randn(M, K, device="cuda", generator=g)
    w = (torch.randn(V, K, device="cuda", generator=g)
         * K ** -0.5).to(torch.bfloat16).T.contiguous()
    route = wg.head_plan(M, V, K, torch.cuda.get_device_properties(
        0).multi_processor_count)
    before = launch_counts()
    out = head_matmul(x32, w)
    split = launch_counts()["split_bf16_terms"] - before["split_bf16_terms"]
    ref = head_matmul_plain(x32, w)
    fault = {"x32_rounded_to_bf16": head_matmul_plain(
        x32.to(torch.bfloat16).float(), w)}
    res = _check_close(f"head_matmul bf16 M={M}", out, ref, HEAD_TOL,
                       fault=fault)
    del out, ref, fault
    if route[0] == "wgmma" and split != 1:
        raise AssertionError(f"phase15 row 14: the tensor-core route ran "
                             f"{split} splits, not 1")
    flops, nbytes = 2.0 * M * K * V, 2 * K * V + 4 * M * K + 4 * M * V
    t_ops, t_bytes = 3 * flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    res.update(
        route=route[0], tile=route[1],
        ms=_time_ms(lambda: head_matmul(x32, w), reps=3, warm=1),
        plain_ms=_time_ms(lambda: head_matmul_plain(x32, w), reps=3,
                          warm=1),
        library_ms=_time_ms(lambda: x32 @ w.float(), reps=3, warm=1),
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        bound_f32_ms=max(flops / PEAK_F32 * 1e3, t_bytes))
    res["share_of_bound"] = res["bound_ms"] / res["ms"]
    log(f"phase15 row 14 at M={M} K={K} V={V} " + json.dumps(res)
        + f" card {smi} (before the tensor-core route this shape took "
        f"283.8 ms on the SIMT route, PERF.md §6)")
    torch.cuda.empty_cache()
    return res


def row1_roles(smi):
    """Row 1 (flash_prefill) at the roles' shapes: the embeddings batch
    (B = 8, S = 1024 on the 8B's H = 32, KVH = 8) and llava's text side
    (B = 1, S = 1024, H = KVH = 32), against its plain version, timed as
    phase 2 times it."""
    import torch

    return {
        "embed 8x1024": check_prefill(8, 1024, 32, 8, 128, torch.bfloat16,
                                      ROLES_BATCH),
        "llava 1x1024": check_prefill(1, 1024, 32, 32, 128, torch.bfloat16,
                                      [615])}


def phase_roles(smi):
    """Phase 15, the llm backend's other roles at published widths:
    embeddings and rerank (the 8B at 32 layers, bf16 and the int8
    recipe), the BERT encoder (bge-large-en-v1.5), and llava-1.5-7b's
    images (dense gRPC at 32 layers; paged, ragged and identity Engines
    at SERVE_LAYERS), the llava legs first: their engines capture CUDA
    graphs, and a ragged engine's capture in a run that had made the
    embeddings calls (timed under torch.profiler) first failed once, its
    capture invalidated between two ops of one layer. The launch counts are zeroed at its start and read
    before the kernel timings at its end (row 14 at M = 8192, row 1 at the
    roles' shapes), whose launches do not count. Returns (the phase's
    launch counts, the timings)."""
    import gc
    import tempfile

    import torch

    from localai_tpu_torch.engine.loader import load_config, load_params
    from localai_tpu_torch.ops.kernels import launch_counts, \
        reset_launch_counts

    os.environ["LOCALAI_ALLOW_SYNTHETIC"] = "1"
    t0 = time.perf_counter()
    reset_launch_counts()
    rows = []

    def settle():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # the legs whose engines capture CUDA graphs run first, before any
    # torch.profiler session of the process (the calls' busy ms)
    with tempfile.TemporaryDirectory() as d:
        n, secs = llava_checkpoint(d)
        log(f"phase15 llava checkpoint: {n} tower and projector values "
            f"written in {secs:.1f} s")
        kept = {}
        rows.append(llava_grpc_leg(d, smi, kept))
        settle()
        cfg = dataclasses.replace(load_config(d, dtype="bfloat16"),
                                  num_layers=SERVE_LAYERS)
        params = load_params(d, cfg, dtype="bfloat16", device="cuda")
        pages = 4 * 8 + 1
        rows.append(llava_engine_leg(
            "llava paged", cfg, params, dict(
                max_slots=4, max_context=2048, prefill_buckets=(1024,),
                prefill_chunk=1024, kv_pages=pages),
            kept["mm"], smi, ("flash_prefill", "ragged_decode_paged",
                              "paged_scatter_append")))
        settle()
        rows.append(llava_engine_leg(
            "llava ragged", cfg, params, dict(
                max_slots=4, max_context=2048, kv_pages=pages,
                ragged_token_budget=192),
            kept["mm"], smi, ("ragged_paged_attention",
                              "ragged_scatter_append",
                              "ragged_decode_paged",
                              "paged_scatter_append")))
        settle()
        rows.append(llava_engine_leg(
            "llava ragged int8 kv", cfg, params, dict(
                max_slots=4, max_context=2048, kv_pages=pages,
                ragged_token_budget=192, cache_type="int8"),
            kept["mm"], smi, ("ragged_paged_attention_q8",
                              "ragged_scatter_append_q8",
                              "ragged_decode_q8_paged",
                              "paged_scatter_append_q8")))
        settle()
        rows.append(llava_identity_leg(cfg, params, kept["mm"], smi))
        del params, kept
        settle()
    with tempfile.TemporaryDirectory() as d:
        log(f"phase15 bert checkpoint written in {bert_checkpoint(d):.1f} s")
        rows.append(roles_bert_leg(d, smi))
    with tempfile.TemporaryDirectory() as d:
        grammar_checkpoint(d, CFG_8B)
        for label, kw in (("8b bf16 embeddings", dict(dtype="bfloat16")),
                          ("8b int8 embeddings", dict(dtype="int8"))):
            torch.cuda.reset_peak_memory_stats()
            rows.append(roles_embed_leg(label, d, kw, smi))
    gc.collect()
    torch.cuda.empty_cache()
    counts = launch_counts()
    timings = {"row14": row14_large_m(smi), "row1": row1_roles(smi)}
    log("phase15 summary " + json.dumps({
        r["leg"]: {k: r.get(k) for k in (
            "layers", "tok_s", "ttft_p50_ms", "cosine", "max_dscore",
            "reference_max_gap", "planted_fault_gap", "tower_ms_per_image",
            "own_rows_equal_tokens")} for r in rows})
        + " scorer (M = 8192) wall · device-busy ms " + json.dumps({
            r["leg"]: r["calls_wall_busy_ms"][SCORER_CALL] for r in rows
            if SCORER_CALL in r.get("calls_wall_busy_ms", {})})
        + " (with the head on the SIMT route, PERF.md §5: bf16 526.2 ·"
        " 520.7, int8 296.8 · 292.8)"
        + f" launches {json.dumps({k: v for k, v in counts.items() if v})}"
        + f" ({time.perf_counter() - t0:.1f} s) card {smi}")
    return counts, timings


KERNELS = {
    "flash_prefill": ("localai_tpu_torch/csrc/flash_prefill.cu",
                      "localai_tpu/ops/pallas/flash_attention.py:133"),
    "ragged_decode": ("localai_tpu_torch/csrc/decode_attention.cu",
                      "localai_tpu/ops/pallas/flash_attention.py:289"),
    "ragged_decode_q8": ("localai_tpu_torch/csrc/decode_attention.cu",
                         "localai_tpu/ops/pallas/flash_attention.py:453"),
    "ragged_decode_paged": ("localai_tpu_torch/csrc/decode_attention.cu",
                            "localai_tpu/ops/pallas/flash_attention.py:248"),
    "ragged_decode_q8_paged": (
        "localai_tpu_torch/csrc/decode_attention.cu",
        "localai_tpu/ops/pallas/flash_attention.py:411"),
    "paged_scatter_append": ("localai_tpu_torch/csrc/paged_scatter.cu",
                             "localai_tpu/ops/pallas/paged_scatter.py:115"),
    "paged_scatter_append_q8": (
        "localai_tpu_torch/csrc/paged_scatter.cu",
        "localai_tpu/ops/pallas/paged_scatter.py:254"),
    "ragged_paged_attention": (
        "localai_tpu_torch/csrc/ragged_attention.cu",
        "localai_tpu/ops/pallas/ragged_attention.py:203"),
    "ragged_paged_attention_q8": (
        "localai_tpu_torch/csrc/ragged_attention.cu",
        "localai_tpu/ops/pallas/ragged_attention.py:297"),
    "ragged_scatter_append": ("localai_tpu_torch/csrc/paged_scatter.cu",
                              "localai_tpu/ops/pallas/ragged_attention.py:490"),
    "ragged_scatter_append_q8": (
        "localai_tpu_torch/csrc/paged_scatter.cu",
        "localai_tpu/ops/pallas/ragged_attention.py:520"),
    # XLA-fused in the reference (no Pallas kernel): the int8 projection's
    # convert + dot, and the f32 lm head's
    "w8a16_matmul": ("localai_tpu_torch/csrc/weight_gemm.cu",
                     "localai_tpu/ops/quant.py:78"),
    "head_matmul": ("localai_tpu_torch/csrc/weight_gemm.cu",
                    "localai_tpu/models/llama.py:347"),
    # Mixtral's int8 expert einsums (dequantize, then XLA's dot)
    "moe_w8_matmul": ("localai_tpu_torch/csrc/weight_gemm.cu",
                      "localai_tpu/models/llama.py:383"),
    # the int4 twins of the three (weight_gemm.cu built with WG_INT4): the
    # reference's jnp.int4 projection, head and expert products
    "w4a16_matmul": ("localai_tpu_torch/csrc/weight_gemm.cu",
                     "localai_tpu/ops/quant.py:78"),
    "head_matmul_int4": ("localai_tpu_torch/csrc/weight_gemm.cu",
                         "localai_tpu/models/llama.py:347"),
    "moe_w4_matmul": ("localai_tpu_torch/csrc/weight_gemm.cu",
                      "localai_tpu/models/llama.py:383"),
    # the bf16 head's x32 split into three bf16 terms for its tensor-core
    # route (part of row 14's port; launched where the scorer's head runs)
    "split_bf16_terms": ("localai_tpu_torch/csrc/weight_gemm.cu",
                         "localai_tpu/models/llama.py:347"),
    # the KV tier's variants of rows 3/5 and 8/9 (on the TPU the tiered
    # reads ride XLA twins: models/llama.py _decode_dq, the ragged
    # _xla_core), and the demotion on row 7's kernel (the reference's
    # engine _demote, XLA)
    "ragged_decode_paged_tier": (
        "localai_tpu_torch/csrc/decode_attention.cu",
        "localai_tpu/ops/pallas/flash_attention.py:248"),
    "ragged_decode_q8_paged_tier": (
        "localai_tpu_torch/csrc/decode_attention.cu",
        "localai_tpu/ops/pallas/flash_attention.py:411"),
    "ragged_paged_attention_tier": (
        "localai_tpu_torch/csrc/ragged_attention.cu",
        "localai_tpu/ops/pallas/ragged_attention.py:203"),
    "ragged_paged_attention_q8_tier": (
        "localai_tpu_torch/csrc/ragged_attention.cu",
        "localai_tpu/ops/pallas/ragged_attention.py:297"),
    "paged_demote_q8": ("localai_tpu_torch/csrc/paged_scatter.cu",
                        "localai_tpu/ops/pallas/paged_scatter.py:254"),
}
# which path's run each kernel's `launches` comes from: PR 1's dense main
# path (phase 4), the paged path (phase 5) or the ragged path (phase 6)
PAGED_KERNELS = ("ragged_decode_paged", "ragged_decode_q8_paged",
                 "paged_scatter_append", "paged_scatter_append_q8")
RAGGED_KERNELS = ("ragged_paged_attention", "ragged_paged_attention_q8",
                  "ragged_scatter_append", "ragged_scatter_append_q8")
# the int4 recipe's kernels, launched in phase 13
INT4_KERNELS = ("w4a16_matmul", "head_matmul_int4", "moe_w4_matmul")


def main():
    import tempfile

    import torch

    t0 = time.perf_counter()
    walls = {}

    def timed(label, fn, *a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        walls[label] = round(time.perf_counter() - t, 1)
        return out

    smi = phase_device()
    with tempfile.TemporaryDirectory() as gdir:
        gtok = grammar_setup(gdir)
        # phase 3's CPU runs go on a thread while the kernels build (nvcc
        # runs in processes of its own); phase 2 starts once both are done,
        # so nothing else runs beside its timings
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            cpu_side = pool.submit(phase3_cpu_side, gtok)
            timed("1 build", phase_build)
            cs = timed("3 cpu side, after the build", cpu_side.result)
        measured = timed("2 kernels", phase_kernels)
        timed("3 card vs cpu", phase_card_vs_cpu, cs)
        timed("3 grammar card vs cpu", phase_grammar_card_vs_cpu, gtok, cs)
        timed("3 graphs", phase_graphs)
        counts = timed("4 main path", phase_main_path)
        paged_counts = timed("5 paged", phase_paged_path, smi)
        ragged_counts = timed(
            "6 ragged (+ 7's ragged waves)", phase_ragged_path, smi,
            grammar_then=lambda name: grammar_ragged(name, smi, gtok))
        timed("7 grammar", phase_grammar, gdir, smi, gtok)
        host_counts, _ = timed("9 host tier", phase_host_tier, gdir, smi,
                               gtok)
        tier_counts = timed("10 kv tier", phase_kv_tier, gdir, smi, gtok,
                            measured["paged_demote_q8"])
        shift_counts = timed("11 shift", phase_shift, gdir, smi, gtok)
    moe_counts = timed("12 mixtral", phase_mixtral, smi)
    int4_counts = timed("13 int4", phase_int4, smi)
    # phase 15 before 14: its engines capture graphs, and phase 14's
    # profiler sessions come after every capture
    roles_counts, roles_timings = timed("15 roles", phase_roles, smi)
    tp_counts, tp_measured = timed("14 tensor parallel", phase_tp, smi)
    spec_counts = timed("8 speculative", phase_spec_path, smi)
    log("phase walls (s) " + json.dumps(walls)
        + f" total {time.perf_counter() - t0:.1f} s")
    log("slowest steps (s, the line that ended each) " + json.dumps(
        sorted(STEPS, reverse=True)[:40]))
    # row 14 at the scorer's M (phase 15) and row 15i4's w2 stack beside
    # their main shapes' readings
    extra = {"head_matmul": {"large_m": roles_timings["row14"]},
             "moe_w4_matmul": {"w2": {
                 k: measured["moe_w4_matmul"]["w2"].get(k)
                 for k in ("ms", "ms_cold", "ms_graph", "bound_ms",
                           "max_abs_err", "library_ms")}}}
    rows = []
    for name, (src, replaces) in KERNELS.items():
        m = measured[name]
        launches = (tier_counts if name in TIER_KERNELS
                    else roles_counts if name == "split_bf16_terms"
                    else ragged_counts if name in RAGGED_KERNELS
                    else paged_counts if name in PAGED_KERNELS
                    else moe_counts if name == "moe_w8_matmul"
                    else int4_counts if name in INT4_KERNELS
                    else counts)[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                     "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                     "bound_by": m["bound_by"],
                     "library_ms": m["library_ms"], "ms_host": m["ms_host"],
                     "library_ms_host": m["library_ms_host"],
                     "ms_cold": m.get("ms_cold"), "ms_graph": m["ms_graph"],
                     **({"ms_graph_cold": m["ms_graph_cold"]}
                        if "ms_graph_cold" in m else {}),
                     "launches_spec": spec_counts[name],
                     "launches_host_tier": host_counts[name],
                     "launches_kv_tier": tier_counts[name],
                     "launches_shift": shift_counts[name],
                     "launches_mixtral": moe_counts[name],
                     "launches_int4": int4_counts[name],
                     "launches_tp": tp_counts[name],
                     "launches_roles": roles_counts[name],
                     **({"library_bf16_ms": m["library_bf16_ms"]}
                        if "library_bf16_ms" in m else {}),
                     **extra.get(name, {})})
    # row 12: the TP wrappers, at rank 0's shard, launches from phase 14
    for name, (src, replaces, unsharded) in SHARDED.items():
        m = tp_measured[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": tp_counts[name],
                     "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                     "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                     "bound_by": m["bound_by"],
                     "library_ms": m["library_ms"], "ms_host": m["ms_host"],
                     "ms_graph": m["ms_graph"],
                     "unsharded_ms": m["unsharded_ms"],
                     "unsharded": unsharded,
                     "launches_roles": roles_counts[name]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
