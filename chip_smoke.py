#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card.

    python3 chip_smoke.py [--rival-wide QUANT_GEMM_CU ...]

Phases (any failure exits non-zero and prints no result line):

1. The card: prints ``nvidia-smi``'s name and power limit; no CUDA device
   is a failure.
2. Build: compiles the kernel sources under ``src/repro_torch/kernels/
   csrc/`` -- ``bw_gemm.cu``, ``bw_gemm_sparse.cu``, ``encode.cu`` and
   ``quant_gemm.cu`` -- with nvcc, one process a library, all started
   together, and prints the build seconds and ptxas' register and spill
   report of each kernel instantiation; a spill in any is a failure.
3. Kernels against their plain versions, at the main path's shapes
   (M, K_pad) in {(2304, 2304), (5760, 2304), (2304, 5888)}.  First
   ``floor_ms``, the timing method's own floor (``cuda_ms`` of an empty
   launch), and per shape ``stream_ms``, a PyTorch reduction over as many
   L2-cold bytes as the live digit planes (a reading of what the card
   streams at that size, not a bound).
   Dense (B1 bw_gemm_fused, B2 bw_gemm), N in {1, 2, 3, 4, 8, 512}, timed
   at N in {1, 4, 512}: seeded weights planned at planes=3, masks with a
   False block over non-zero digits; torch.profiler must see exactly one
   device operation per B1 and per B2 call at every N (one session).
   B2's edges: weights planned at planes 2, 3 and 4 and bit-serially,
   digits of 2, 3, 4 and 8 planes (masks with a False block over
   non-zero digits), a ragged 2311 x 2320 weight through ops.bw_gemm
   against the exact product, 80 x 128 blocks and two calls in a row, at
   N in {1, 3, 4, 8}.
   Sparse (B3 bw_gemm_sparse_fused, B4 bw_gemm_sparse) and pipelined (B5
   bw_gemm_sparse_fused_pipelined, B6 bw_gemm_sparse_pipelined), N in
   {1, 2, 3, 4, 8}: seeded weights at planes=2, schedules in both orders
   built from masks with a False block over non-zero digits, and from a
   mask with an all-empty row block as well (a sentinel); then, at N=3,
   an all-sentinel mask and a schedule shorter than the grid, at N=4 a
   planes=3 (density 0.75) plan and two calls in a row on one stream
   with different activations.  The cases must split some m-block row's
   entries across CTAs (bw_gemm.pipelined_ranges over the grid).  B4/B3
   against their plain versions, B6/B5 on both orders against the same
   plain versions and bit for bit against B4/B3.  torch.profiler must see
   exactly one device operation per B3 and per B4 call, and one (a
   pipelined_kernel) per B5 and per B6 call, on both orders; the
   wrapper's shared-memory layout must equal the library's over a grid of
   block shapes and widths.  B1 is timed on the same planes=2 plans and
   masks, the bar for B3, and held bit-identical to B3 there.  The edges
   of B1-B4's work split, at N in {1, 2, 3, 4, 8}: runs of very different
   lengths (a 92-entry run and a sentinel-only m-block, so some B3/B4
   CTAs search for their run), zero-weight padding, block_k 16 (runs of
   up to 576 entries) and block_m 24; B1-B4 against their plain
   versions, B3 == B1 and B4 == B2 on the mask the schedule was built
   from.  B7 ent_encode: uniform int8 and planes=3 weights at the three
   shapes and at 768 x 4096, the 256 int8 values tiled, and a 768 x 4096
   zero input with one non-zero byte planted in most plan blocks (in the
   block's last 16-byte chunk, which the CTA's last warp encodes in its
   last pass; values whose top live plane changes from block to block),
   at blocks 128 x 256 (the plans'), 128 x 128 (the reference's
   default), 24 x 16 and 128 x 1024 (a CTA loops over four passes);
   digits and mask must be bit-identical, and torch.profiler must see
   exactly one device operation a call; timed at 128 x 256.  B9
   quant_gemm and B8 quant_gemm_fused, T in {1, 2, 3, 4, 8, 16, 17, 64,
   512}, each in both orientations (the weight as A [M, K] with T token columns B [K, T], as
   the planned path calls B9, and T token rows A [T, K] with the weight
   as B [K, M], as the serving path calls B8), at the three shapes and a
   ragged one (M 2311, K 2320): both epilogue axes, with and without a
   bias, under every activation, and in bfloat16; two calls in a row on
   one stream with different operands (at T=4 and T=512); torch.profiler must see
   exactly one device operation per B8 and per B9 call at every width,
   and the wrapper's work split (quant_gemm._layout) must equal the
   library's over a grid of shapes and grids.  At T=512 one layer's
   seven calls are logged beside torch._int_mm, ``floor_ms`` and the
   bound; each ``--rival-wide QUANT_GEMM_CU`` names another design's
   source whose wide kernel meets stream-K (as the designs this one
   replaced did), which is built, held to the same plain versions and
   timed beside them.  Integer results, and
   fused results without an activation, must be bit-identical to the
   plain versions; with an activation within rtol 1e-5, atol 1e-6 (the
   card's expf/tanhf against torch's own kernels, and gelu's 1 + tanh
   cancellation for negative inputs).
   Each kernel is timed L2-cold (``cuda_ms``, the median of 24 calls),
   with its plain version, and torch._int_mm on the undecomposed int8
   weight as a yardstick the port never calls; B3/B4 on m_major
   schedules, B5/B6 on k_major ones, as they serve; B8 on axis 'n'
   without a bias.
4. The path: ServeEngine on the full-width minicpm-2b config (all 40
   layers), params from a seeded torch.Generator, 8 seeded prompts of 8-24
   tokens, batch 4, 16 new tokens, max_len 64, on the same params: at
   planes=3 through impl=pallas_fused, impl=pallas and the plain
   impl=planes oracle, and at planes=2 (the fast tier) through
   impl=pallas_fused, impl=pallas_sparse and impl=pallas_pipelined.  The
   routes of a plane budget must emit the same tokens, and each kernel's
   launch count -- every count zeroed just before each run, read just
   after -- must be 7 * layers * steps on its own route and 0 elsewhere.
   torch.profiler then traces three more decode steps of each route:
   device time per step, the kernels' share of it, the route kernel's
   time and device operations a step (one a call: 7 * layers), and the
   device's busy share of the step time measured without the profiler.
5. The kernel-level API on every dense weight of the same params (7 * 40
   = 280), one weight at a time, at the main path's planes=3 spec: the
   plan with ``ops.plan_operand(encode_impl="kernel")`` (B7) must equal
   the oracle's in digits, mask, schedule and permutations;
   ``ops.quant_gemm(qw.T, xq.T)`` (B9) must equal ``ops.bw_gemm(plan,
   xq.T)`` (B2) and ``ops.quant_gemm_fused(xq, qw, s).T`` (B8) must equal
   ``ops.bw_gemm_fused(plan, xq.T, s)`` (B1) bit for bit, for seeded
   per-token int8 activations xq [4, K]; a second pass with silu holds B8
   against B1 within the tolerance above.  Every count is zeroed first;
   the plain pass must launch B7, B9, B8, B2 and B1 280 times each and the
   silu pass B8 and B1 280 times each, every other kernel 0.  Logs the
   host seconds to plan the 280 weights with each encoder.

6. The serving stack on the same params, cut to their first
   SERVER_DEPTH (5) of 40 layers for the script's time
   (``server_phase``), after ``ops.plan_cache_clear()`` and the earlier
   phases' engines are freed:
   8 seeded prompts of 8-24 tokens, 16 new tokens, Poisson arrivals
   (``serving.loadgen``).  (a) ``AsyncServer`` in virtual mode on the
   default ladder's two tiers (fast planes=2, quality planes=4, both
   pallas_fused and per-token, routed round robin): every request
   completes, B1 is launched 7 * layers * the workers' steps and every
   other kernel never.  (b) The same load in realtime mode (one thread a
   tier): the same tiers and tokens; tok/s, TTFT/TPOT p50/p99 and peak GB
   are logged.  Every request's tokens must equal a standalone
   ``ServeEngine.run`` of its tier's spec.  (c) Twin planes=3 tiers in
   restore mode: ``a`` is killed at the first pump (found by a virtual
   run of the same load) after which one of its slots is past its
   prompt; every request completes with the uninterrupted tokens, with
   at least one slot restored and none re-prefilled.

7. The static analyzers and the measured autotuner on the same params
   (``autotune_phase``).  (a) Every weight planned at planes=3 m_major
   with ``verify=True`` (a plan with an error diagnostic raises) and
   without, the host seconds of each logged; every verified schedule is
   in the verification memo; the three projection shapes are also
   planned k_major, and ``analysis.crosscheck_cost`` is clean for
   pallas_fused and pallas_sparse on an m_major plan of each shape and for
   pallas_pipelined on each k_major plan.  The host us a call of the
   seams on the served path is logged: the 'auto' dispatch with its cache
   probe, the threshold alone, a fixed route, the verification seam with
   ``REPRO_VERIFY`` unset (``seam_host_cost``).  (b) For every candidate of the
   sweep, the shared-memory pass's pipelined footprint equals the
   library's layout at N=4 (``pipelined_layout_of_kernel``): it fits
   exactly when the library lays it out, with equal bytes.  (c)
   ``autotune_gemm`` at the three projection shapes (2304x2304,
   5760x2304, 2304x5760), N=4, for planes 2, 3 and 4 (24 candidates each,
   216 in all), timed on the card: every candidate's route, blocks and
   device us and each winner logged, the winners saved to a temporary
   cache file (removed when the phase ends); the checked-in cache
   validates.  (d) planes=2 pallas_sparse (dispatch 'auto') serves 3 of
   the prompts with ``REPRO_AUTOTUNE_CACHE`` naming that file: each
   projection launches the kernel of the route the file names for its
   (shape, density bucket), or the 0.5 threshold's where no entry
   transfers to an m_major plan, and the tokens equal phase 4's planes=2
   tokens; ``plan_stats["schedules_verified"]`` is logged.  (e) The same
   with no env var: B3 on every projection, no cache hit, the same
   tokens.

8. The full-sequence forward and the dense configs, after the earlier
   phases' params are freed.  First B1 (with a bias, under every
   activation) and B2 at the forward's widths N in {256, 4096} at the
   three path shapes, against their plain versions (``wide_cases``).
   (a) ``lm_apply`` on the same full-width minicpm-2b params at planes=3
   through pallas_fused (B1), pallas (B2) and the planes oracle, at
   batch 4 x 64 tokens (plain causal attention) and batch 1 x 4,096
   tokens (the chunked online-softmax walk: 4,096 > attn_chunk 2,048):
   each kernel route launches its kernel 7 x 40 times a forward and no
   other, the oracle none; the three routes' greedy tokens are equal at
   every position; then ``lm_prefill`` of the first 48 tokens of the
   first size and 16 ``lm_decode_step``s (teacher-forced) give the
   forward's logits at positions 47-63 within PREFILL_LOGIT_ATOL, and
   on the mean within PREFILL_MEAN_ATOL (the card orders float32 sums
   by shape; both set from measured sound and broken decodes), and its
   greedy tokens but at near-ties (B1 launched 7 x 40 x 17 times).  Host
   and device ms a forward (torch.profiler), B1/B2's part of it beside
   B1's bound over the 280 plans (``b1_bound_ms``) and peak GB are
   logged.  (b) nemotron-4-15b (2 of 32 layers: relu2 in B1's
   epilogue, LayerNorm, GQA 8, an untied head of 256,000 rows),
   qwen1.5-110b (1 of 80: the qkv bias in B1's epilogue, a head of
   152,064 rows) and granite-34b (1 of 88: MQA, wk/wv of 128 rows, a
   head of 49,152 rows), one at a time, at their published widths, an
   eighth of the depth one card's 80 GB holds beside the embedding and
   the planned head, or one layer (for the script's time); params from a seeded
   torch.Generator; each served by
   ServeEngine (batch 3, 3 seeded prompts of 8-24 tokens, 8 new tokens,
   max_len 32) through pallas_fused and the planes oracle (and pallas
   where the MLP folds its activation): B1 launched (6 or 7) x layers +
   1 times a step and nothing else; ms/step, peak GB and B1's longest
   launch in a profiled decode step (the head's) beside its bound
   logged.  Both routes'
   logits teacher-forced through the served sequences must be
   bit-identical and the tokens equal where no activation is folded;
   nemotron's oracle rounds the up projection to bfloat16 before relu2
   (the plain engines' epilogue order, in the reference too), so there
   B1's lock-step logits must be within ACT_ATOL / ACT_RTOL of B2's
   (whose epilogue is B1's in plain float32) and B2's served tokens
   equal B1's, and the oracle's gap is logged.

9. The MoE configs (``moe_config_phase``), after phase 8's params are
   freed: olmoe-1b-7b whole (16 layers, d_model 2048, 16 x 128 heads, 64
   experts top-8, d_ff 1024, an untied head of 50,304 rows) and
   grok-1-314b at its published widths (d_model 6144, 48 / 8 heads x 128,
   8 experts top-2, d_ff 32,768, tanh-gelu non-gated experts, soft cap
   30, a head of 131,072 rows) at 2 of its 64 layers, one at a time,
   params from a seeded torch.Generator, each served by ServeEngine
   (batch 3, 3 seeded prompts of 8-24 tokens, 8 new tokens, max_len 32)
   through pallas_fused and the planes oracle.  Only wq, wk, wv, wo and
   the untied head are planned: B1 launched 4 x layers + 1 times a step
   and nothing else (the router stays raw, the experts are bf16
   einsums), the oracle nothing.  Both routes' logits teacher-forced
   through the served sequences must be bit-identical and the served
   tokens equal.  ms/step, device and B1 ms a step, the experts' device
   ms a step (a profiler range around ``moe._experts``: the bf16 weight
   copies, the einsums, the activation), peak GB, init and plan seconds
   and the share of the oracle's decode picks dropped by capacity are
   logged.  On olmoe-1b-7b ``lm_apply`` of 4 x 64 tokens through both
   routes' params: 4 x 16 + 1 = 65 B1 launches a forward, none on the
   oracle, equal greedy tokens.  The phase's seconds are logged.

10. The VLM config (``vlm_config_phase``), after phase 9's params are
   freed: phi-3-vision-4.2b at its published widths (32 layers, d_model
   3072, 32 x 96 heads, MHA, d_ff 8192, an untied head of 32,128 rows;
   3.821 B params beside frontend_proj's 9.4 M), params drawn whole from
   a seeded torch.Generator and run on their first CONFIG_DEPTH (8)
   layers for the script's time, through pallas_fused and the planes
   oracle.  frontend_proj, the vision stub's projection, is a bf16
   matmul, never planned: B1 launched 7 x 8 + 1 = 57 times a decode step
   or forward and nothing else, the oracle nothing.  (a)
   Served by ServeEngine on text (batch 3, 3 seeded prompts of 8-24
   tokens, 8 new, max_len 32): lock-step logits bit-identical, served
   tokens equal; ms/step, device and B1 ms a step, kernels a step, the
   head's B1 launch beside its bound and peak GB logged.  (b) The
   multimodal forward, batch 2 x 1,024 tokens whose positions 0-575 are
   overwritten by seeded float32 frontend embeddings [2, 576, 3072]:
   greedy tokens at positions 576-1,023 equal on both routes (phase 8
   (a)'s gate), finite logits [2, 1024, 32128]; on B1 host, device and
   B1 ms beside ``b1_bound_ms`` at N=2,048, and a forward with the
   frontend + 1.0 must change the logits.  (c) On B1, ``lm_prefill`` of
   one such 1,024-token prompt with its frontend, then 16
   ``lm_decode_step``s, against ``lm_apply`` over the 1,040 tokens with
   the same frontend, within PREFILL_LOGIT_ATOL / PREFILL_MEAN_ATOL.  (d)
   On B1, ``loss_fn`` on (b)'s batch, labels at every position: the
   masked mean NLL of (b)'s logits over positions 576-1,023 within rtol
   1e-6, 2 x 448 tokens counted.  The phase's seconds are logged.

11. The RWKV config (``rwkv_config_phase``), after phase 10's params are
   freed: rwkv6-3b at its published widths (32 layers, d_model 2560, 40
   heads x 64, d_ff 8960, an untied head of 65,536 rows; 3.100 B params),
   params drawn whole from a seeded torch.Generator with the seven
   constant leaves drawn, run on their first CONFIG_DEPTH (8) layers,
   through pallas_fused and the planes oracle, TF32 off.  Eight weights
   a layer and the head are planned (the mixing LoRAs are float32
   matmuls, mix_w2 an einsum): B1 launched 8 x 8 + 1 = 65 times a decode
   step or forward and nothing else, the oracle nothing.  (a) Served by
   ServeEngine (batch 3, 4 seeded prompts of 8-24 tokens, 8 new,
   max_len 32: the fourth reuses a slot, whose recurrent row is reset):
   lock-step logits bit-identical, served tokens equal, and on B1 the
   fourth request's tokens equal to its run alone on a fresh engine;
   ms/step, device and B1 ms a step, kernels a step, the head's B1
   launch beside its bound and peak GB logged.  (b) The forward, 2 x
   512 seeded tokens: 65 B1 launches on pallas_fused, none on the
   oracle, finite logits [2, 512, 65536], equal greedy tokens; on B1
   host, device and B1 ms beside ``b1_bound_ms`` (the profiler's raw
   device events), the recurrence's device ms (one layer's scan at the
   forward's shapes, profiled alone, times the layers) and the rest's,
   peak GB.
   (c) On B1, the forward of 256 tokens with ``return_state``, then 16
   teacher-forced ``rwkv_lm_decode_step``s, against the forward of all
   272, gated at the first layer of the params
   (``RWKV_GATE_DEPTH``: at 32 layers the card's shape-ordered float32
   sums part two forwards as far as any broken decode), the sound decode
   within ``RWKV_LOGIT_ATOL`` / ``RWKV_MEAN_ATOL`` and each of three
   broken decodes (the handed-over shift rows zeroed, the wkv state
   zeroed, u left out) outside them.  (d) On B1, ``loss_fn`` on (b)'s
   batch, labels at every position: the forward's mean NLL within rtol
   1e-6, 1,024 tokens counted.  The phase's seconds are logged.

12. The hybrid config (``hybrid_config_phase``), after phase 11's params
   are freed: hymba-1.5b at its published widths (32 layers, d_model
   1600, 25 heads x 64 with 5 kv heads, d_ff 5504, ssm_state 16, an
   untied head of 32,128 rows; 1.663 B params), params drawn whole from
   a seeded torch.Generator with the fusion's betas and the SSM's d_skip
   drawn, run on their first CONFIG_DEPTH (8) layers, through
   pallas_fused and the planes oracle, TF32 off.  Nine weights a layer
   (attention, in_proj / out_proj, the MLP) and the head are planned
   (the SSM's x_to_dt, dt_proj and x_to_bc are float32 matmuls): B1
   launched 9 x 8 + 1 = 73 times a decode step or forward and nothing
   else, the oracle nothing.  (a) Served by ServeEngine (batch 3, 4 seeded prompts of
   8-24 tokens, 8 new, max_len 32: the fourth reuses a slot, whose KV
   ring and SSM rows are reset): lock-step logits bit-identical, served
   tokens equal, and on B1 the fourth request's tokens equal to its run
   alone on a fresh engine; ms/step, device and B1 ms a step, kernels a
   step, the head's B1 launch beside its bound and peak GB logged.  (b)
   The forward, 2 x 384 seeded tokens after the 128 meta tokens: 73 B1
   launches on pallas_fused, none on the oracle, finite logits [2, 384,
   32128], equal greedy tokens; on B1 host, device and B1 ms beside
   ``b1_bound_ms``, the SSM scan's device ms (one layer's scan at the
   forward's shapes, profiled alone, times the layers) and the rest's,
   peak GB.
   (c) ``_windowed_chunked`` against ``_windowed`` on seeded bf16 q / k /
   v [1, 4096, 25, 64], W and chunk 2,048, within HYMBA_WINDOW_RTOL of
   the largest value.  (d) On B1, the forward without meta over 2 x 32
   tokens against 32 teacher-forced ``hymba_lm_decode_step``s on the
   first ``HYMBA_GATE_DEPTH`` layers: the sound decode within
   ``HYMBA_LOGIT_ATOL`` / ``HYMBA_MEAN_ATOL``, and each of three broken
   decodes (the SSM state zeroed at each step, the conv state zeroed,
   the KV ring not carried) outside them.  (e) On B1,
   ``loss_fn`` on (b)'s batch, labels at every position: the forward's
   mean NLL within rtol 1e-6, 768 tokens counted.  The phase's seconds
   are logged.

13. The encoder-decoder config (``encdec_config_phase``), after phase
   12's params are freed: seamless-m4t-medium whole (12 encoder + 12
   decoder layers, d_model 1024, 16 heads x 64, d_ff 4096, LayerNorm, an
   un-gated gelu MLP folded into B1's epilogue, an untied head of
   256,256 rows; 0.88 B params), params from a seeded torch.Generator,
   through pallas_fused (B1), pallas (B2) and the planes oracle, TF32
   off.  193 weights are planned (frontend_proj, a bf16 matmul, is
   not): the route's kernel launched 8 x 12 + 1 = 97 times a decode step
   and 193 times a forward, and nothing else; the oracle nothing.  B1
   (with and without the gelu) and B2 against their plain versions on
   the served plans at N 3, 128 and 1,024.  (a) Served by ServeEngine
   (batch 3, 4 seeded prompts of 8-24 tokens, 8 new, max_len 32: the
   fourth reuses a slot) against the zero cross K/V, as the reference
   serves: B1's lock-step logits within ``ENCDEC_ACT_GAP`` of B2's
   (greedy tokens equal but where the top-2 margin is within it); the
   oracle, which rounds before the gelu (ROADMAP C7), logged against B1
   with the margin at each flip; on B1 the fourth request's tokens equal
   to its run alone on a fresh engine; ms/step, device and B1 ms a step,
   kernels a step, the head's B1 launch beside its bound, peak GB and
   planning seconds logged.  (b) The forward, 2 x 64 seeded tokens over
   2 x 512 seeded frames, on B1 and B2: finite logits [2, 64, 256256],
   B2's within ``ENCDEC_ACT_GAP`` of B1's; host and device ms, the
   kernel's ms at N 1,024 (the priming's calls, profiled alone) and 128
   beside ``b1_bound_ms``, peak GB.  (c) On B1, ``encdec_prime_cross``
   then 64 teacher-forced ``encdec_decode_step``s against (b)'s forward,
   on all 12 decoder layers: the sound decode within
   ``ENCDEC_LOGIT_ATOL`` / ``ENCDEC_MEAN_ATOL``, and each of three
   broken decodes (cross K/V left zero, the two requests' cross rows
   swapped, the self cache one position off) outside them.  (d) On B1,
   ``loss_fn`` on (b)'s batch, labels at every position: the forward's
   mean NLL within rtol 1e-6, 128 tokens counted.  The phase's seconds
   and the script's are logged.

The kernels line gives, per kernel, one layer's seven launches at N=4
(four 2304x2304, two 5760x2304 and one 2304x5888 products; B7: one
encode of each plan shape; B8/B9 at T=4 in phase 5's orientations):
``ms`` the kernel, ``plain_ms`` the plain version, ``library_ms``
torch._int_mm (B7: null, no single PyTorch call encodes), ``bound_ms``
the larger of the bytes they must move at 3.35 TB/s and their int8
operations at 1979 TOP/s (H100 SXM data sheet), counted from this run's
masks and schedules (live plane blocks only) and the operands each timed
call passes: the live digits, the activations, the mask (dense) or the
schedule (sparse, pipelined), the output (int32, or float32 when fused)
and, when fused, the scale vectors; fused kernels are timed without a
bias.  ``floor_ms`` is phase 3's timing floor, one call's (``ms`` holds
seven).  B7 moves its input and four digit planes and the mask; B8/B9
their two int8 operands and the output (B8: and its scale).  A line
before it gives B1, B2, B8 and B9 at N=512.  ``launches`` is the count
on the kernel's own route: pallas_fused at planes=3 for B1 (with phase
9's two served MoE configs, phase 10's served VLM and phases 11's, 12's
and 13's two served B1 runs each added), pallas for B2 (with phase 13's
served B2 run added), pallas_sparse for B3 and pallas_pipelined for
B5.  B4 and B6, the unfused twins, serve no engine; after the pallas_sparse and
pallas_pipelined runs, every planned weight of the served model goes
once through planned_dense_apply(fused=False) on the engine's sparse
route (B4 on its m_major plans, B6 on the k_major ones), held
bit-identical to the dense route (B2) on the same record, and their
counts are read from that pass.  B7-B9 serve no engine either: their
counts are phase 5's plain pass.  The last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12            # H100 SXM, data sheet
INT8_OPS_PER_S = 1979e12             # H100 SXM dense int8, data sheet
PATH_SHAPES = ((2304, 2304, 4), (5760, 2304, 2), (2304, 5888, 1))
DENSE_NS = (1, 2, 3, 4, 8, 512)      # phase 3's widths for B1/B2
TIMED_NS = (1, 4, 512)               # ... of which timed
ACT_RTOL, ACT_ATOL = 1e-5, 1e-6
QUANT_TS = (1, 2, 3, 4, 8, 16, 17, 64, 512)   # phase 3's widths for B8/B9
# M, K of no tile but 16 (per_layer 0: checked, not timed)
RAGGED_SHAPE = (2311, 2320, 0)
# B7's block shapes: the plans', the reference's default, a small odd one,
# and one a CTA takes in four passes (csrc/encode.cu ent_threads)
ENCODE_BLOCKS = ((128, 256), (128, 128), (24, 16), (128, 1024))
# the bytes planted one a block in B7's sparse case, block after block:
# top live planes 0, 1, 1, 2, 2, 3, 3, 3, 3, and an empty block
ENCODE_PLANTED = (1, -3, 4, -12, 16, -48, 64, -128, 127, 0)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return res.stdout.strip() or res.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def cuda_ms(fn, iters: int = 24, warmup: int = 3) -> float:
    """Median device ms of one fn(i) call, by a CUDA event pair around each.

    The host issues a small kernel more slowly than the card runs it, so
    events around a loop of launches would time the host.  Each call is
    instead queued behind a sleep kernel (eight times the slowest warm-up
    call's host time, at <= 2 GHz), so its start event fires only when
    the card reaches it, and the pair times the device alone.  The median
    of the pairs leaves out a pair whose call the host issued late all
    the same.  ``repro_torch.kernels.autotune._device_seconds`` is the
    same method (in seconds); keep the two in step.
    """
    import torch
    host_s = 0.0
    for i in range(warmup):
        t0 = time.perf_counter()
        fn(i)
        host_s = max(host_s, time.perf_counter() - t0)
    cycles = int(16e9 * host_s) + 100_000
    torch.cuda.synchronize()
    pairs = []
    for i in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn(i)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return times[len(times) // 2]


def cold_copies(t, total_bytes: float = 150e6):
    """Copies of ``t`` that together exceed the 50 MB L2 three times over,
    so a timing loop cycling through them reads device memory, as the
    serving path (whose 40 layers hold distinct weights) does.  The
    autotuner's ``_cold_copies`` is the same; keep the two in step."""
    return [t.clone() for _ in range(max(2, -(-int(total_bytes)
                                              // t.nbytes)))]


def kernel_cases(dev, log):
    """Phase 3: both kernels against their plain versions, timed."""
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels import bw_gemm as bwk
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(1234)
    per_kernel = {"bw_gemm_fused": [], "bw_gemm": []}
    err = {"bw_gemm_fused": 0.0, "bw_gemm": 0.0}
    one_op = []                   # (what, call, kernel) at the first shape
    for m, k, per_layer in PATH_SHAPES:
        w = torch.randn((k, m), generator=gen, device=dev)
        qw, sw = quant.quantize_to_planes(w, 3, axis=0)
        planned = ops.plan_operand(qw.t(), "ent", 128, 256)
        digits, mask = planned.digits, planned.mask.clone()
        k_pad = digits.shape[2]
        # a False block over non-zero digits in each of planes 0..2
        for p in range(3):
            kk = p % mask.shape[2]
            if not bool(digits[p, :128, 256 * kk:256 * (kk + 1)].any()):
                raise AssertionError(f"plane {p} block (0, {kk}) is empty")
            mask[p, 0, kk] = False
        scale = ops._channel_rows(sw.reshape(-1), m, digits.shape[1],
                                  planned.row_perm)
        wq_pad = torch.zeros((digits.shape[1], k_pad), dtype=torch.int8,
                             device=dev)
        wq_pad[:m, :k] = qw.t()
        bias = torch.randn((digits.shape[1], 1), generator=gen, device=dev)
        live_ms = stream_ms(digits, 3)
        log(f"  stream_ms M={digits.shape[1]} K={k_pad} planes=3: "
            f"{live_ms:.5f} ms (float32 sum over {3 * digits[0].numel()} "
            f"L2-cold bytes)")
        for n in DENSE_NS:
            x = torch.randn((n, k), generator=gen, device=dev)
            qx, sx = quant.quantize_to_planes(x, 3, axis=-1)
            b = torch.zeros((n, k_pad), dtype=torch.int8, device=dev)
            b[:, :k] = qx
            sx_cols = sx.reshape(1, -1).contiguous()
            kw = dict(block_m=128, block_k=256, radix=4)
            nnz = int(mask.sum())
            m_pad = digits.shape[1]
            live_bytes = nnz * 128 * 256
            ops_n = 2 * live_bytes * n
            # bytes each timed call moves: live digits, activations, mask,
            # the output; bw_gemm_fused also reads scale [M] and scale_n [N]
            moved = {"bw_gemm": live_bytes + b.numel() + mask.numel()
                     + 4 * m_pad * n}
            moved["bw_gemm_fused"] = moved["bw_gemm"] + 4 * (m_pad + n)

            got = bwk.bw_gemm(digits, b, mask, **kw)
            want = bwk.bw_gemm_plain(digits, b, mask, **kw)
            torch.cuda.synchronize()
            err["bw_gemm"] = max(err["bw_gemm"],
                                 float((got - want).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"bw_gemm != plain at M={m} K={k_pad} "
                                     f"N={n}")
            for act in (None, "silu", "gelu", "relu2"):
                args = (digits, b, mask, scale, bias if act else None,
                        sx_cols)
                got = bwk.bw_gemm_fused(*args, activation=act, **kw)
                want = bwk.bw_gemm_fused_plain(*args, activation=act, **kw)
                torch.cuda.synchronize()
                diff = float((got - want).abs().max())
                err["bw_gemm_fused"] = max(err["bw_gemm_fused"], diff)
                if act is None:
                    ok = torch.equal(got, want)
                else:
                    ok = bool(torch.all((got - want).abs()
                                        <= ACT_ATOL + ACT_RTOL * want.abs()))
                if not ok:
                    raise AssertionError(
                        f"bw_gemm_fused[{act}] != plain at M={m} "
                        f"K={k_pad} N={n}: max |diff| {diff}")
            if m == PATH_SHAPES[0][0] and k == PATH_SHAPES[0][1]:
                one_op += [
                    (f"bw_gemm_fused N={n}",
                     lambda d=digits, b=b, mk=mask, s=scale, sx=sx_cols:
                     bwk.bw_gemm_fused(d, b, mk, s, None, sx, **kw),
                     "bw_gemm_fused_kernel"),
                    (f"bw_gemm N={n}",
                     lambda d=digits, b=b, mk=mask: bwk.bw_gemm(d, b, mk,
                                                                **kw),
                     "bw_gemm_i32_kernel")]
            if n not in TIMED_NS:
                continue

            # timing, L2-cold: kernel, plain version, torch._int_mm
            b8 = torch.zeros((max(8, n), k_pad), dtype=torch.int8,
                             device=dev)
            b8[:n] = b
            wq_cold = cold_copies(wq_pad)
            try:
                torch._int_mm(wq_pad, b8.t())
                lib_ms = cuda_ms(lambda i: torch._int_mm(
                    wq_cold[i % len(wq_cold)], b8.t()))
            except RuntimeError as e:
                log(f"  torch._int_mm unavailable at M={m} K={k_pad}: {e}")
                lib_ms = None
            del wq_cold
            d_cold = cold_copies(digits)
            for name, fn, plain in (
                    ("bw_gemm_fused",
                     lambda i: bwk.bw_gemm_fused(
                         d_cold[i % len(d_cold)], b, mask, scale, None,
                         sx_cols, **kw),
                     lambda i: bwk.bw_gemm_fused_plain(
                         digits, b, mask, scale, None, sx_cols, **kw)),
                    ("bw_gemm",
                     lambda i: bwk.bw_gemm(d_cold[i % len(d_cold)], b, mask,
                                           **kw),
                     lambda i: bwk.bw_gemm_plain(digits, b, mask, **kw))):
                row = {"m": m_pad, "k_pad": k_pad, "n": n,
                       "per_layer": per_layer,
                       "ms": cuda_ms(fn), "plain_ms": cuda_ms(plain, 5, 1),
                       "library_ms": lib_ms, "stream_ms": live_ms,
                       "bytes": moved[name], "ops": ops_n,
                       "live_blocks": nnz, "blocks": mask.numel()}
                row["bound_ms"] = 1e3 * max(row["bytes"] / HBM_BYTES_PER_S,
                                            row["ops"] / INT8_OPS_PER_S)
                per_kernel[name].append(row)
                log(f"  {name:14s} M={row['m']:5d} K={k_pad:5d} N={n}  "
                    f"kernel {row['ms']:.4f} ms  plain "
                    f"{row['plain_ms']:.4f} ms  _int_mm "
                    f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms"
                    f"  bound {row['bound_ms']:.4f} ms")
            del d_cold
    counts = one_device_op_each(one_op)
    log(f"  bw_gemm, bw_gemm_fused: one device operation a call at N in "
        f"{DENSE_NS}: {len(one_op)} calls, {json.dumps(counts)}")
    return per_kernel, err


SPARSE = ("bw_gemm_sparse_fused", "bw_gemm_sparse",
          "bw_gemm_sparse_fused_pipelined", "bw_gemm_sparse_pipelined")
BASELINE = ("ent_encode", "quant_gemm_fused", "quant_gemm")
KERNELS = ("bw_gemm_fused", "bw_gemm") + SPARSE + BASELINE


def kernel_fns() -> dict:
    """Kernel name -> its wrapper, which carries the ``launches`` count."""
    from repro_torch.kernels import bw_gemm as bwk
    from repro_torch.kernels import encode, quant_gemm
    fns = {name: getattr(bwk, name) for name in KERNELS[:-3]}
    fns.update(ent_encode=encode.ent_encode,
               quant_gemm_fused=quant_gemm.quant_gemm_fused,
               quant_gemm=quant_gemm.quant_gemm)
    return fns


def zero_counts() -> None:
    for fn in kernel_fns().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_fns().items()}


SPARSE_NS = (1, 2, 3, 4, 8)          # phase 3's widths for B3-B6
B1_PLANES2 = "bw_gemm_fused on the planes=2 plan"   # the bar for B3
ACTS = (None, "silu", "gelu", "relu2")


def split_rows(sched, n: int, ctas: int) -> int:
    """m-block rows of a pipelined call whose live entries fall in more
    than one CTA's range (bw_gemm.pipelined_ranges)."""
    from repro_torch.kernels import bw_gemm as bwk
    s = sched.cpu()
    steps = s.shape[0]
    owner = {}
    for c, (lo, hi) in enumerate(bwk.pipelined_ranges(
            bwk.pipelined_work(steps, n), ctas)):
        for f in range(lo, hi):
            row, weight = int(s[f % steps, 1]), int(s[f % steps, 3])
            if weight:
                owner.setdefault((f // steps, row), set()).add(c)
    return sum(len(cs) > 1 for cs in owner.values())


def device_ops(fn, least: int = 1, tries: int = 10) -> dict:
    """Name -> count of the device operations (kernels, memsets, copies)
    that one fn() call queues, by torch.profiler: fn() runs once in a
    warm-up step and once in the active step, and only the active step
    counts (the tracer has been seen to miss a session's first launches,
    every time, once torch._int_mm has run).  A trace that holds fewer
    than ``least`` device events is taken again, up to ``tries`` times:
    the tracer has also been seen to drop the first 26 of 36 launches of
    an active step.  A trace with more events is returned as it is."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    seen = {}

    def active_step(prof):            # the step's own annotation aside
        seen.update({e.key[:60]: e.count for e in prof.key_averages()
                     if str(getattr(e, "device_type", "")).endswith("CUDA")
                     and not e.key.startswith("ProfilerStep")})

    for attempt in range(tries):
        time.sleep(0.25 * attempt)
        seen.clear()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=active_step) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        if sum(seen.values()) >= least:
            break
        log(f"  device_ops: trace {attempt + 1} held "
            f"{sum(seen.values())} of at least {least} device events, "
            f"taken again")
    return seen


def one_device_op(what: str, call, kernel: str) -> dict:
    """torch.profiler's device operations of one call(); exactly one, a
    ``kernel``, or AssertionError."""
    seen = device_ops(call)
    if sum(seen.values()) != 1 or not all(kernel in key for key in seen):
        raise AssertionError(f"{what}: {seen} device operations a call, "
                             f"expected one {kernel}")
    return seen


def one_device_op_each(checks) -> dict:
    """torch.profiler over every call of ``checks`` ((what, call, kernel)
    triples), each call once (device_ops): the device operations must be
    exactly one ``kernel`` a call -- every operation a kernel the checks
    name, and each kernel as many times as calls name it -- or
    AssertionError.  Returns kernel -> count."""
    import collections
    want = collections.Counter(kernel for _, _, kernel in checks)

    def every_call():
        for _, call, _ in checks:
            call()

    got = collections.Counter()
    for key, count in device_ops(every_call, least=len(checks)).items():
        names = [kernel for kernel in want if kernel in key]
        if len(names) != 1:
            raise AssertionError(f"{checks[0][0]} ... {checks[-1][0]}: "
                                 f"device operation {key!r} x{count}, "
                                 f"expected only {sorted(want)}")
        got[names[0]] += count
    if got != want:
        raise AssertionError(f"{checks[0][0]} ... {checks[-1][0]}: device "
                             f"operations {dict(got)} for {len(checks)} "
                             f"calls, expected one a call: {dict(want)}")
    return dict(got)


def floor_ms() -> float:
    """The timing method's own floor: ``cuda_ms`` of an empty launch (a
    sleep kernel of 0 cycles)."""
    import torch
    return cuda_ms(lambda i: torch.cuda._sleep(0))


def stream_ms(digits, planes: int) -> float:
    """What the card streams at a kernel's size: a PyTorch reduction over
    as many L2-cold bytes as the live digit planes (digits[:planes]) --
    a reading, not a bound.  The bytes are summed as float32, which torch
    reduces without widening them (an int32 sum widens to int64 and runs
    at about half the rate)."""
    import torch
    cold = cold_copies(digits[:planes].contiguous().view(torch.float32))
    ms = cuda_ms(lambda i: cold[i % len(cold)].sum())
    del cold
    return ms


def layout_agreement() -> int:
    """The pipelined kernels' shared-memory layout as the wrapper computes
    it (bw_gemm._pipelined_layout) against the library's own
    (bw_gemm_sparse_pipelined_layout), over a grid of block shapes and
    widths: both must accept and refuse the same cases, with the same
    layout.  Returns the number of cases."""
    from repro_torch.kernels import bw_gemm as bwk
    cases = 0
    for n in (1, 2, 3, 4, 8, 16):
        for bm in (8, 16, 24, 64, 128, 256, 384, 512, 1024, 2048, 4096):
            for bk in (16, 32, 48, 128, 256, 384, 512, 1024, 2048, 4096,
                       8192):
                try:
                    want = bwk._pipelined_layout(n, bm, bk)
                except ValueError:
                    want = None
                got = bwk.pipelined_layout_of_kernel(n, bm, bk)
                if got != want:
                    raise AssertionError(
                        f"pipelined layout at N={n} block_m={bm} "
                        f"block_k={bk}: kernel {got}, wrapper {want}")
                cases += 1
    return cases


def quant_layout_agreement() -> int:
    """B8/B9's work split as the wrapper computes it (quant_gemm._layout)
    against the library's own (quant_gemm_layout), over a grid of shapes,
    designs and grids: both must accept and refuse the same cases, with
    the same layout.  Returns the number of cases."""
    from repro_torch.kernels import quant_gemm as qg
    cases = 0
    dims = (1, 3, 4, 16, 17, 64, 2304, 2311)
    for m in dims:
        for n in dims:
            for k in (16, 48, 2304, 2320, 5888):
                grids = {1, 7, 132, 270, 288, 576}
                for design in range(len(qg.DESIGNS) + 1):
                    for ctas in sorted(grids | {qg.launch_plan(
                            m, n, k, 132)["ctas"]}):
                        try:
                            want = qg._layout(m, n, k, design, ctas)
                        except ValueError:
                            want = None
                        got = qg.layout_of_kernel(m, n, k, design, ctas)
                        if got != want:
                            raise AssertionError(
                                f"quant_gemm layout at m={m} n={n} k={k} "
                                f"design={design} ctas={ctas}: kernel "
                                f"{got}, wrapper {want}")
                        cases += 1
    return cases


def sparse_cases(dev, log):
    """Phase 3, B3-B6: B4 and B3 against their plain versions on m_major
    schedules; B6 and B5 on both orders against the same plain versions
    and bit for bit against B4 and B3; timed."""
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels import bw_gemm as bwk
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(4321)
    per_kernel = {name: [] for name in SPARSE + (B1_PLANES2,)}
    err = dict.fromkeys(SPARSE, 0.0)
    kw = dict(block_m=128, block_k=256)
    cases = 0

    def check(name, got, want, exact, what):
        torch.cuda.synchronize()
        diff = float((got - want).abs().max())
        err[name] = max(err[name], diff)
        ok = torch.equal(got, want) if exact else bool(torch.all(
            (got - want).abs() <= ACT_ATOL + ACT_RTOL * want.abs()))
        if not ok:
            raise AssertionError(f"{name} != {what}: max |diff| {diff}")

    def schedules(mask):
        return tuple(torch.from_numpy(ops.build_schedule(mask, 4, order)).to(
            dev) for order in ops.SCHEDULE_ORDERS)

    def hold(where, digits, b, scheds, scale, bias, sx_cols):
        """B3-B6 on one operand pair, every activation."""
        nonlocal cases
        sm = scheds[0]
        want = bwk.bw_gemm_sparse_plain(digits, b, sm, **kw)
        b4 = bwk.bw_gemm_sparse(digits, b, sm, **kw)
        check("bw_gemm_sparse", b4, want, True, f"plain at {where}")
        for order, sched in zip(ops.SCHEDULE_ORDERS, scheds):
            b6 = bwk.bw_gemm_sparse_pipelined(digits, b, sched, **kw)
            check("bw_gemm_sparse_pipelined", b6, want, True,
                  f"plain at {where} {order}")
            check("bw_gemm_sparse_pipelined", b6, b4, True,
                  f"bw_gemm_sparse at {where} {order}")
        for act in ACTS:
            args = (scale, bias if act else None, sx_cols)
            want = bwk.bw_gemm_sparse_fused_plain(
                digits, b, sm, *args, activation=act, **kw)
            b3 = bwk.bw_gemm_sparse_fused(digits, b, sm, *args,
                                          activation=act, **kw)
            check("bw_gemm_sparse_fused", b3, want, act is None,
                  f"plain at {where} act={act}")
            for order, sched in zip(ops.SCHEDULE_ORDERS, scheds):
                b5 = bwk.bw_gemm_sparse_fused_pipelined(
                    digits, b, sched, *args, activation=act, **kw)
                check("bw_gemm_sparse_fused_pipelined", b5, want,
                      act is None, f"plain at {where} {order} act={act}")
                check("bw_gemm_sparse_fused_pipelined", b5, b3, True,
                      f"bw_gemm_sparse_fused at {where} {order} "
                      f"act={act}")
        cases += 1

    def activations(n, k, k_pad, planes):
        x = torch.randn((n, k), generator=gen, device=dev)
        qx, sx = quant.quantize_to_planes(x, planes, axis=-1)
        b = torch.zeros((n, k_pad), dtype=torch.int8, device=dev)
        b[:, :k] = qx
        return b, sx.reshape(1, -1).contiguous()

    def plan(m, k, planes):
        w = torch.randn((k, m), generator=gen, device=dev)
        qw, sw = quant.quantize_to_planes(w, planes, axis=0)
        planned = ops.plan_operand(qw.t(), "ent", 128, 256)
        m_pad = planned.digits.shape[1]
        scale = ops._channel_rows(sw.reshape(-1), m, m_pad, planned.row_perm)
        return qw, planned, scale

    grids = {(n, fused): bwk._pipelined_ctas(dev, n, 128, 256, fused)
             for n in SPARSE_NS for fused in (False, True)}
    for n in SPARSE_NS:
        lay = bwk.pipelined_layout_of_kernel(n, 128, 256)
        log(f"  pipelined layout at N={n}, blocks 128 x 256: {lay}; grid "
            f"B6 {grids[n, False]} CTAs, B5 {grids[n, True]} CTAs")
    log(f"  pipelined layout: wrapper == kernel on "
        f"{layout_agreement()} (N, block_m, block_k) cases")
    split_seen = {}
    for m, k, per_layer in PATH_SHAPES:
        qw, planned, scale = plan(m, k, 2)
        digits = planned.digits
        m_pad, k_pad = digits.shape[1], digits.shape[2]
        masked = planned.mask.clone()
        # a False block over non-zero digits in planes 0 and 1
        for p in range(2):
            kk = p % masked.shape[2]
            if not bool(digits[p, :128, 256 * kk:256 * (kk + 1)].any()):
                raise AssertionError(f"plane {p} block (0, {kk}) is empty")
            masked[p, 0, kk] = False
        sentinel = masked.clone()
        sentinel[:, 1, :] = False              # row block 1: a sentinel
        bias = torch.randn((m_pad, 1), generator=gen, device=dev)
        wq_pad = torch.zeros((m_pad, k_pad), dtype=torch.int8, device=dev)
        wq_pad[:m, :k] = qw.t()
        timed = {}
        for n in SPARSE_NS:
            b, sx_cols = activations(n, k, k_pad, 2)
            for mask_name, mask in (("masked", masked),
                                    ("sentinel", sentinel)):
                scheds = schedules(mask)
                hold(f"M={m_pad} K={k_pad} N={n} {mask_name}", digits, b,
                     scheds, scale, bias, sx_cols)
                for order, sched in zip(ops.SCHEDULE_ORDERS, scheds):
                    split_seen[order] = split_seen.get(order, 0) + split_rows(
                        sched, n, grids[n, True])
                if mask_name == "masked":
                    timed[n] = (b, sx_cols, scheds)
        # an all-sentinel mask; a schedule shorter than the grid (a few
        # live blocks); two calls in a row on one stream
        empty = torch.zeros_like(masked)
        few = torch.zeros_like(masked)
        few[0, ::5, 0] = True
        few[1, -1, -1] = True
        b3n, sx3 = activations(3, k, k_pad, 2)
        for name, mask in (("all-sentinel", empty), ("short", few)):
            scheds = schedules(mask)
            if name == "short" and not all(
                    s.shape[0] < grids[3, f] for s in scheds
                    for f in (False, True)):
                raise AssertionError(
                    f"the short schedule ({scheds[0].shape[0]} entries) is "
                    f"not shorter than the grid")
            hold(f"M={m_pad} K={k_pad} N=3 {name} (L={scheds[0].shape[0]})",
                 digits, b3n, scheds, scale, bias, sx3)
        b_a, sx_a = timed[4][:2]
        b_b, sx_b = activations(4, k, k_pad, 2)
        sm, sk = timed[4][2]
        for order, sched in zip(ops.SCHEDULE_ORDERS, (sm, sk)):
            r6 = [bwk.bw_gemm_sparse_pipelined(digits, bb, sched, **kw)
                  for bb in (b_a, b_b)]
            r5 = [bwk.bw_gemm_sparse_fused_pipelined(
                digits, bb, sched, scale, bias, sx, activation="silu", **kw)
                for bb, sx in ((b_a, sx_a), (b_b, sx_b))]
            for i, (bb, sx) in enumerate(((b_a, sx_a), (b_b, sx_b))):
                what = f"call {i + 1} of two in a row at M={m_pad} {order}"
                check("bw_gemm_sparse_pipelined", r6[i],
                      bwk.bw_gemm_sparse(digits, bb, sm, **kw), True, what)
                check("bw_gemm_sparse_fused_pipelined", r5[i],
                      bwk.bw_gemm_sparse_fused(digits, bb, sm, scale, bias,
                                               sx, activation="silu", **kw),
                      True, what)
        cases += 1
        # planes=3: density 0.75, both orders
        _, planned3, scale3 = plan(m, k, 3)
        b43, sx43 = activations(4, k, k_pad, 3)
        hold(f"M={m_pad} K={k_pad} N=4 planes=3", planned3.digits, b43,
             schedules(planned3.mask), scale3, bias, sx43)
        del planned3

        # one device operation a call: B3 and B4, and B5 and B6 on both
        # orders
        if m == PATH_SHAPES[0][0] and k == PATH_SHAPES[0][1]:
            b, sx_cols, scheds = timed[4]
            for name, kern, call in (
                    ("bw_gemm_sparse_fused", "sparse_fused_kernel",
                     lambda: bwk.bw_gemm_sparse_fused(
                         digits, b, scheds[0], scale, bias, sx_cols,
                         activation="silu", **kw)),
                    ("bw_gemm_sparse", "sparse_i32_kernel",
                     lambda: bwk.bw_gemm_sparse(digits, b, scheds[0],
                                                **kw))):
                log(f"  {name}: device operations a call "
                    f"{one_device_op(name, call, kern)}")
            for order, sched in zip(ops.SCHEDULE_ORDERS, scheds):
                for name, call in (
                        ("bw_gemm_sparse_pipelined",
                         lambda: bwk.bw_gemm_sparse_pipelined(
                             digits, b, sched, **kw)),
                        ("bw_gemm_sparse_fused_pipelined",
                         lambda: bwk.bw_gemm_sparse_fused_pipelined(
                             digits, b, sched, scale, bias, sx_cols,
                             activation="silu", **kw))):
                    ops_seen = one_device_op(f"{name} on {order}", call,
                                             "pipelined_kernel")
                    log(f"  {name} {order}: device operations a call "
                        f"{ops_seen}")

        # timing, L2-cold, on the masked case's schedules; B1 on the same
        # plan and mask (planes 2-3 masked off) as the bar for B3
        live_ms = stream_ms(digits, 2)
        log(f"  stream_ms M={m_pad} K={k_pad} planes=2: {live_ms:.5f} ms "
            f"(float32 sum over {2 * digits[0].numel()} L2-cold bytes)")
        for n in (1, 4):
            b, sx_cols, (sm, sk) = timed[n]
            if not torch.equal(
                    bwk.bw_gemm_fused(digits, b, masked, scale, None,
                                      sx_cols, **kw),
                    bwk.bw_gemm_sparse_fused(digits, b, sm, scale, None,
                                             sx_cols, **kw)):
                raise AssertionError(f"bw_gemm_fused != bw_gemm_sparse_fused"
                                     f" on one planes=2 plan at M={m_pad} "
                                     f"N={n}")
            b8 = torch.zeros((8, k_pad), dtype=torch.int8, device=dev)
            b8[:n] = b
            wq_cold = cold_copies(wq_pad)
            lib_ms = cuda_ms(lambda i: torch._int_mm(
                wq_cold[i % len(wq_cold)], b8.t()))
            del wq_cold
            d_cold = cold_copies(digits)
            nnz = int(masked.sum())
            live_bytes = nnz * 128 * 256
            for name, sched in (("bw_gemm_sparse_fused", sm),
                                ("bw_gemm_sparse", sm),
                                ("bw_gemm_sparse_fused_pipelined", sk),
                                ("bw_gemm_sparse_pipelined", sk),
                                (B1_PLANES2, masked)):
                fused = "fused" in name
                args = (scale, None, sx_cols) if fused else ()
                kname = "bw_gemm_fused" if name == B1_PLANES2 else name
                kern = getattr(bwk, kname)
                plain = getattr(bwk, kname + "_plain")
                # bytes the call moves: live digits, activations, schedule
                # (B1: mask), the output, and the two scale vectors when
                # fused
                aux = sched.numel() * (1 if name == B1_PLANES2 else 4)
                moved = (live_bytes + b.numel() + aux
                         + 4 * m_pad * n + (4 * (m_pad + n) if fused else 0))
                row = {"m": m_pad, "k_pad": k_pad, "n": n,
                       "per_layer": per_layer,
                       "ms": cuda_ms(lambda i: kern(
                           d_cold[i % len(d_cold)], b, sched, *args, **kw)),
                       "plain_ms": cuda_ms(lambda i: plain(
                           digits, b, sched, *args, **kw), 5, 1),
                       "library_ms": lib_ms, "stream_ms": live_ms,
                       "bytes": moved,
                       "ops": 2 * live_bytes * n, "live_blocks": nnz,
                       "steps": int(sched.shape[0]),
                       "blocks": masked.numel()}
                row["bound_ms"] = 1e3 * max(row["bytes"] / HBM_BYTES_PER_S,
                                            row["ops"] / INT8_OPS_PER_S)
                per_kernel[name].append(row)
                log(f"  {name:30s} M={m_pad:5d} K={k_pad:5d} N={n}  kernel "
                    f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
                    f"_int_mm {lib_ms:.4f} ms  bound "
                    f"{row['bound_ms']:.4f} ms")
            del d_cold
    if not all(split_seen.get(order) for order in ops.SCHEDULE_ORDERS):
        raise AssertionError(f"no case split an m-block row's entries "
                             f"across CTAs: {split_seen}")
    log(f"  B3-B6: {cases} cases bit-exact (B5 == B3, B6 == B4 on both "
        f"orders); m-block rows split across CTAs, summed over the main "
        f"cases: {split_seen}")
    return per_kernel, err


def window_misses(sched, mblks: int) -> int:
    """m-blocks whose B3/B4 CTAs miss the first window of the schedule
    (bw_gemm.schedule_window) and search for their run instead."""
    from repro_torch.kernels import bw_gemm as bwk
    rows = sched[:, 1].tolist()
    misses = 0
    for mblk in range(mblks):
        start, width = bwk.schedule_window(len(rows), mblks, mblk)
        misses += not (width > 0 and (start == 0 or rows[start] < mblk) and (
            start + width == len(rows) or rows[start + width - 1] > mblk))
    return misses


def walk_cases(dev, log) -> int:
    """Phase 3, the edges of B1-B4's work split (csrc/bw_gemm.cu,
    csrc/bw_gemm_sparse.cu):
    runs of very different lengths (a 92-entry run, a sentinel-only
    m-block, so B3/B4 windows miss and CTAs search), zero-weight padding,
    block_k 16 (576-entry runs: several passes of the block list), and
    block_m 24.  At N in {1, 2, 3, 4, 8}: B2, B1 (every activation), B4
    and B3 against their plain versions, and B3 == B1, B4 == B2 bit for
    bit on the mask the schedule was built from.  Returns the cases."""
    import torch
    from repro_torch.kernels import bw_gemm as bwk
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(1618)

    def digits_of(m, k, planes):
        d = torch.randint(-2, 3, (4, m, k), generator=gen, device=dev,
                          dtype=torch.int8)
        d[planes:] = 0
        return d

    skew = torch.rand((4, 6, 23), generator=gen, device=dev) < 0.15
    skew[:, 0] = True                   # a 92-entry run
    skew[:, 2] = False                  # a sentinel-only m-block
    uniform = torch.rand((4, 5, 9), generator=gen, device=dev) < 0.5
    uniform[2:] = False
    long_runs = torch.rand((4, 2, 144), generator=gen, device=dev) < 0.9
    small = torch.rand((4, 3, 2), generator=gen, device=dev) < 0.7
    # (what, digits, mask, block_m, block_k, extra zero-weight entries)
    setups = [("skewed 768 x 5888", digits_of(768, 5888, 4), skew, 128, 256,
               0),
              ("padded 640 x 2304", digits_of(640, 2304, 2), uniform, 128,
               256, 37),
              ("block_k 16, 256 x 2304", digits_of(256, 2304, 4), long_runs,
               128, 16, 0),
              ("block_m 24, 72 x 512", digits_of(72, 512, 3), small, 24, 256,
               0)]
    cases = 0
    for what, digits, mask, bm, bk, pad in setups:
        m, k = digits.shape[1:]
        sched = ops.build_schedule(mask, 4, "m_major")
        if pad:
            sched = ops.pad_schedule(sched, sched.shape[0] + pad)
        misses = window_misses(sched, mask.shape[1])
        sched = torch.from_numpy(sched).to(dev)
        kw = dict(block_m=bm, block_k=bk)
        scale = torch.rand((m, 1), generator=gen, device=dev) * 1e-2
        bias = torch.randn((m, 1), generator=gen, device=dev)
        for n in SPARSE_NS:
            b = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                              dtype=torch.int8)
            sx = torch.rand((1, n), generator=gen, device=dev) * 1e-1
            where = f"{what} N={n}"
            b2 = bwk.bw_gemm(digits, b, mask, **kw)
            b4 = bwk.bw_gemm_sparse(digits, b, sched, **kw)
            torch.cuda.synchronize()
            for name, got, want in (
                    ("bw_gemm", b2, bwk.bw_gemm_plain(digits, b, mask, **kw)),
                    ("bw_gemm_sparse", b4, bwk.bw_gemm_sparse_plain(
                        digits, b, sched, **kw)),
                    ("bw_gemm_sparse == bw_gemm", b4, b2)):
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} != plain at {where}")
            for act in ACTS:
                args = (scale, bias if act else None, sx)
                b1 = bwk.bw_gemm_fused(digits, b, mask, *args,
                                       activation=act, **kw)
                b3 = bwk.bw_gemm_sparse_fused(digits, b, sched, *args,
                                              activation=act, **kw)
                torch.cuda.synchronize()
                for name, got, want in (
                        ("bw_gemm_fused", b1, bwk.bw_gemm_fused_plain(
                            digits, b, mask, *args, activation=act, **kw)),
                        ("bw_gemm_sparse_fused", b3,
                         bwk.bw_gemm_sparse_fused_plain(
                             digits, b, sched, *args, activation=act,
                             **kw))):
                    ok = torch.equal(got, want) if act is None else bool(
                        torch.all((got - want).abs()
                                  <= ACT_ATOL + ACT_RTOL * want.abs()))
                    if not ok:
                        raise AssertionError(f"{name}[{act}] != plain at "
                                             f"{where}")
                if not torch.equal(b3, b1):
                    raise AssertionError(f"bw_gemm_sparse_fused[{act}] != "
                                         f"bw_gemm_fused at {where}")
            cases += 1
        log(f"  walk edges, {what}: {int(mask.sum())} live blocks, schedule "
            f"{sched.shape[0]} entries, {misses} of {mask.shape[1]} m-blocks "
            f"search past the first window; B1-B4 == plain, B3 == B1, "
            f"B4 == B2 at N in {SPARSE_NS}")
    return cases


def dense_edge_cases(dev, log) -> int:
    """Phase 3, B2 (bw_gemm, csrc/bw_gemm.cu) at the edges: weights
    planned at planes 2, 3 and 4 and bit-serially (8 planes, radix 2), and
    digits of exactly 2, 3, 4 and 8 planes, each with a False block over
    non-zero digits, at N in {1, 3, 4, 8}; a ragged 2311 x 2320 weight
    through ops.bw_gemm against the exact product, and 80 x 128 blocks on
    2320 x 2304; two calls in a row on one stream.  Every result
    bit-identical to the plain version.  Returns the cases."""
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels import bw_gemm as bwk
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref

    gen = torch.Generator(device=dev).manual_seed(3141)
    cases = 0

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def hold(what, digits, mask, bm, bk, radix):
        nonlocal cases
        kw = dict(block_m=bm, block_k=bk, radix=radix)
        for n in (1, 3, 4, 8):
            b = int8(n, digits.shape[2])
            got = bwk.bw_gemm(digits, b, mask, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, bwk.bw_gemm_plain(digits, b, mask,
                                                      **kw)):
                raise AssertionError(f"bw_gemm != plain on {what} at "
                                     f"N={n}")
            cases += 1

    m, k = 2304, 2304
    w = torch.randn((k, m), generator=gen, device=dev)
    for planes, encoding in ((2, "ent"), (3, "ent"), (4, "ent"),
                             (4, "bitserial")):
        qw, _ = quant.quantize_to_planes(w, planes, axis=0)
        pl = ops.plan_operand(qw.t(), encoding, 128, 256)
        mask = pl.mask.clone()
        if not bool(pl.digits[0, :128, :256].any()):
            raise AssertionError(f"{encoding} planes={planes}: plane 0 "
                                 f"block (0, 0) is empty")
        mask[0, 0, 0] = False
        hold(f"{encoding} plan at planes={planes} "
             f"({pl.digits.shape[0]} digit planes)", pl.digits, mask, 128,
             256, 2 if encoding == "bitserial" else 4)
    for bw_n in (2, 3, 4, 8):
        lo, hi = (-1, 2) if bw_n == 8 else (-2, 3)
        digits = torch.randint(lo, hi, (bw_n, 640, 2304), generator=gen,
                               device=dev, dtype=torch.int8)
        mask = torch.rand((bw_n, 5, 9), generator=gen, device=dev) < 0.6
        mask[0, 0, 0] = False
        hold(f"{bw_n} digit planes", digits, mask, 128, 256,
             2 if bw_n == 8 else 4)
    # ragged: the ops layer pads a 2311 x 2320 weight to the blocks
    wq = int8(2311, 2320)
    pl = ops.plan_operand(wq, "ent", 128, 256)
    for n in (1, 4, 8):
        x = int8(2320, n)
        got = ops.bw_gemm(pl, x)
        if not torch.equal(got, kref.quant_gemm_ref(wq, x)):
            raise AssertionError(f"ops.bw_gemm != the exact product on a "
                                 f"ragged 2311 x 2320 weight at N={n}")
        cases += 1
    digits = torch.randint(-2, 3, (4, 2320, 2304), generator=gen,
                           device=dev, dtype=torch.int8)
    mask = torch.rand((4, 29, 18), generator=gen, device=dev) < 0.6
    mask[0, 0, 0] = False
    hold("2320 x 2304 at blocks 80 x 128", digits, mask, 80, 128, 4)
    # two calls in a row on one stream, different activations, one sync
    digits, mask = pl.digits, pl.mask
    kw = dict(block_m=128, block_k=256, radix=4)
    for n in (4, 8):
        bs = [int8(n, digits.shape[2]) for _ in range(2)]
        outs = [bwk.bw_gemm(digits, b, mask, **kw) for b in bs]
        torch.cuda.synchronize()
        for i, (b, got) in enumerate(zip(bs, outs)):
            if not torch.equal(got, bwk.bw_gemm_plain(digits, b, mask,
                                                      **kw)):
                raise AssertionError(f"bw_gemm call {i + 1} of two in a "
                                     f"row != plain at N={n}")
        cases += 1
    log(f"  bw_gemm edges: {cases} cases bit-identical to the plain "
        f"version (plans at planes 2, 3, 4 and bit-serial, 2-8 digit "
        f"planes, ragged, 80 x 128 blocks, two in a row)")
    return cases


def rival_wide(source, log):
    """Another design's B8/B9 source (``--rival-wide``: a quant_gemm.cu
    whose wide kernel meets its CTAs stream-K, in arrival counters and
    partial slots passed after ``out``, as the design this one replaced
    did), built like the shipped one and returned as call(a, b, out,
    scale=None), which launches its wide kernel on its own plan: its
    layout's tiles and K units, as many CTAs as fit the SMs by its shared
    memory, zeroed counters and slots of up to 128 x 256 int32 a CTA and
    tile.  Checked and timed beside the shipped wide kernel at T=512; no
    wrapper launches it."""
    import ctypes
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import quant_gemm as qg
    source = Path(source).resolve()
    lib_path = _build.BUILD_DIR / f"librival-{source.stat().st_mtime_ns}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                          str(_build.CSRC), "-o", str(lib_path), str(source)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on the rival {source}:\n"
                           f"{res.stdout}{res.stderr}")
    log(f"  rival wide design {source} built in "
        f"{time.perf_counter() - t0:.1f} s")
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.quant_gemm_i32.argtypes = [p] * 5 + [i] * 5 + [p]
    lib.quant_gemm_fused.argtypes = [p] * 7 + [i] * 8 + [p]
    lib.quant_gemm_layout.argtypes = [i] * 5 + [p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    work = {}

    def call(a, b, out, scale=None):
        m, k = a.shape
        n = b.shape[1]
        lay = (ctypes.c_int * 5)()
        if lib.quant_gemm_layout(m, n, k, qg.WIDE, 1, lay) != 0:
            raise RuntimeError(f"rival refuses wide at {m}x{n}x{k}")
        tiles, units, smem = lay[1], lay[2], lay[4]
        ctas = min(tiles * units, sms * max(1, 232448 // (smem + 1024)))
        if (tiles, ctas) not in work:
            work[tiles, ctas] = (
                torch.zeros(tiles, dtype=torch.int32, device=a.device),
                torch.empty(2 * ctas * 128 * 256, dtype=torch.int32,
                            device=a.device))
        counters, slots = (t.data_ptr() for t in work[tiles, ctas])
        stream = torch.cuda.current_stream().cuda_stream
        if scale is None:
            err = lib.quant_gemm_i32(a.data_ptr(), b.data_ptr(),
                                     out.data_ptr(), counters, slots, m, n,
                                     k, qg.WIDE, ctas, stream)
        else:
            err = lib.quant_gemm_fused(a.data_ptr(), b.data_ptr(),
                                       scale.data_ptr(), None, out.data_ptr(),
                                       counters, slots, m, n, k, qg.WIDE,
                                       ctas, 1, 0, 0, stream)
        if err != 0:
            raise RuntimeError(f"rival launch failed with CUDA error {err}")
        return out

    return call


def baseline_cases(dev, log, rival_sources=()):
    """Phase 3, B7-B9: against their plain versions, timed; at T=512 a
    rival wide design beside B8/B9's shipped one (rival_wide)."""
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels import encode
    from repro_torch.kernels import quant_gemm as qg

    gen = torch.Generator(device=dev).manual_seed(2718)
    per_kernel = {name: [] for name in BASELINE}
    err = dict.fromkeys(BASELINE, 0.0)
    wide_ms = {"quant_gemm": 0.0, "quant_gemm_fused": 0.0}
    wide_bound = dict(wide_ms)
    wide_lib = 0.0
    rivals = {str(src): rival_wide(src, log) for src in rival_sources}
    on_rival = {src: dict(wide_ms) for src in rivals}

    def int8(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def check(name, got, want, exact, what):
        torch.cuda.synchronize()
        diff = float((got.float() - want.float()).abs().max())
        err[name] = max(err[name], diff)
        ok = torch.equal(got, want) if exact else bool(torch.all(
            (got - want).abs() <= ACT_ATOL + ACT_RTOL * want.abs()))
        if not ok:
            raise AssertionError(f"{name} != {what}: max |diff| {diff}")

    def row(name, ms, plain_ms, lib_ms, moved, ops_n, **shape):
        r = dict(shape, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                 bytes=moved, ops=ops_n)
        r["bound_ms"] = 1e3 * max(moved / HBM_BYTES_PER_S,
                                  ops_n / INT8_OPS_PER_S)
        per_kernel[name].append(r)
        lib = "-" if lib_ms is None else f"{lib_ms:.4f}"
        log(f"  {name:16s} {shape}  kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  _int_mm {lib} ms  bound "
            f"{r['bound_ms']:.4f} ms")

    # B7 ent_encode at the plan shapes: uniform int8, and a seeded weight
    # on the planes=3 grid (plane 3 empty), and the 256 int8 values, at
    # every block shape of ENCODE_BLOCKS, and a byte planted a block where
    # only the last warp's flags can set the mask; one device operation a
    # call; timed at the plans' blocks
    kw7 = dict(block_m=128, block_k=256)
    every = torch.arange(-128, 128, dtype=torch.int8,
                         device=dev).repeat(384).reshape(384, 256)
    cases = [("all 256 int8 values", every)]
    for m, k, per_layer in PATH_SHAPES + ((768, 4096, 0),):
        w = torch.randn((m, k), generator=gen, device=dev)
        cases += [(f"uniform {m}x{k}", int8(m, k)),
                  (f"planes=3 {m}x{k}",
                   quant.quantize_to_planes(w, 3, axis=1)[0].contiguous())]
    def planted(bm, bk, m=768, k=4096):
        """Zeros, and in block (i, j) the byte ENCODE_PLANTED[(i * kb +
        j) % 10] in the block's last row and last 16-byte chunk, at
        column (i * kb + j) % 16 of it."""
        x = torch.zeros((m, k), dtype=torch.int8, device=dev)
        kb = k // bk
        i = torch.arange(m // bm, device=dev)[:, None]
        j = torch.arange(kb, device=dev)[None, :]
        at = (i * kb + j).expand(m // bm, kb)
        vals = torch.tensor(ENCODE_PLANTED, dtype=torch.int8, device=dev)
        x[i * bm + bm - 1, j * bk + bk - 16 + at % 16] = \
            vals[at % len(ENCODE_PLANTED)]
        return x

    checks = []
    for bm, bk in ENCODE_BLOCKS:
        blocks = dict(block_m=bm, block_k=bk)
        for what, x in cases + [("one byte a block, in the last warp's "
                                 "last chunk", planted(bm, bk))]:
            if x.shape[0] % bm or x.shape[1] % bk:
                continue
            d, mask = encode.ent_encode(x, **blocks)
            dp, mp = encode.ent_encode_plain(x, **blocks)
            where = f"{what}, blocks {bm} x {bk}"
            check("ent_encode", d, dp, True, f"plain digits on {where}")
            check("ent_encode", mask, mp, True, f"plain mask on {where}")
            planes = mp.flatten(1)
            if what.startswith("one byte") and (
                    bool(planes.all(1).any()) or not bool(planes.any(1).all())):
                raise AssertionError(f"ent_encode: the planted mask on "
                                     f"{where} has a full or empty plane")
            checks.append((f"ent_encode {where}",
                           lambda x=x, blocks=blocks: encode.ent_encode(
                               x, **blocks), "ent_encode_kernel"))
    counts = one_device_op_each(checks)
    log(f"  ent_encode: bit-identical to the plain version on "
        f"{len(checks)} (input, blocks) cases, blocks {ENCODE_BLOCKS}; "
        f"one device operation a call: {json.dumps(counts)}")
    for m, k, per_layer in PATH_SHAPES:
        x = cases[[c[0] for c in cases].index(f"planes=3 {m}x{k}")][1]
        x_cold = cold_copies(x)
        row("ent_encode",
            cuda_ms(lambda i: encode.ent_encode(x_cold[i % len(x_cold)],
                                                **kw7)),
            cuda_ms(lambda i: encode.ent_encode_plain(x, **kw7), 5, 1), None,
            5 * m * k + 4 * (m // 128) * (k // 256), 0, m=m, k_pad=k,
            n=None, per_layer=per_layer)
        del x_cold

    # B9 quant_gemm and B8 quant_gemm_fused at every width T, each in both
    # orientations: the weight as A [M, K] with T token columns B [K, T]
    # (B9 as the planned path calls it) and T token rows A [T, K] with the
    # weight as B [K, M] (B8 as the serving path calls it); a ragged shape
    # as well (M and K multiples of no tile but 16)
    def orientations(w, wt, x, xt):
        return (("weight as A", w, xt), ("weight as B", x, wt))

    def whole(a, b):
        """Blocks of the reference's contract that divide any shape."""
        return dict(block_m=a.shape[0], block_n=b.shape[1], block_k=16)

    for m, k, per_layer in PATH_SHAPES + (RAGGED_SHAPE,):
        w = int8(m, k)                     # the weight's rows [M, K]
        wt = w.t().contiguous()            # [K, M]
        for t in QUANT_TS:
            x = int8(t, k)
            xt = x.t().contiguous()
            for orient, a, b in orientations(w, wt, x, xt):
                where = f"M={m} K={k} T={t} {orient}"
                blocks = whole(a, b)
                check("quant_gemm", qg.quant_gemm(a, b, **blocks),
                      qg.quant_gemm_plain(a, b, **blocks), True,
                      f"plain at {where}")
                for axis in ("n", "m"):
                    shape = ((1, b.shape[1]) if axis == "n"
                             else (a.shape[0], 1))
                    scale = torch.rand(shape, generator=gen,
                                       device=dev) * 1e-3
                    bias = torch.randn(shape, generator=gen, device=dev)
                    for act in ACTS:
                        for bb in (None, bias):
                            fkw = dict(blocks, activation=act,
                                       epilogue_axis=axis)
                            check("quant_gemm_fused",
                                  qg.quant_gemm_fused(a, b, scale, bb, **fkw),
                                  qg.quant_gemm_fused_plain(a, b, scale, bb,
                                                            **fkw),
                                  act is None, f"plain at {where} "
                                  f"axis={axis} act={act} "
                                  f"bias={bb is not None}")
                    bkw = dict(blocks, epilogue_axis=axis,
                               out_dtype=torch.bfloat16)
                    check("quant_gemm_fused",
                          qg.quant_gemm_fused(a, b, scale, bias, **bkw),
                          qg.quant_gemm_fused_plain(a, b, scale, bias, **bkw),
                          True, f"plain at {where} axis={axis} bf16")
            if per_layer == 0 or t not in (4, 512):
                continue
            # timing, L2-cold on the weight: B9 (weight as A), B8 (weight
            # as B, axis 'n', no bias), their plain versions, torch._int_mm
            # on the same product
            kw9 = dict(block_m=128, block_n=min(t, 128), block_k=256)
            kw8 = dict(block_m=min(t, 128), block_n=128, block_k=256)
            xpad = torch.zeros((max(8, t), k), dtype=torch.int8, device=dev)
            xpad[:t] = x
            w_cold = cold_copies(w)
            where = f"M={m} K={k} T={t}"
            try:
                torch._int_mm(w, xpad.t())
                lib_ms = cuda_ms(lambda i: torch._int_mm(
                    w_cold[i % len(w_cold)], xpad.t()))
            except RuntimeError as e:
                log(f"  torch._int_mm unavailable at {where}: {e}")
                lib_ms = None
            shape = dict(m=m, k_pad=k, n=t, per_layer=per_layer)
            wt_cold = cold_copies(wt)
            scale = torch.rand((1, m), generator=gen, device=dev)
            b9 = (lambda i: qg.quant_gemm(w_cold[i % len(w_cold)], xt, **kw9))
            b8 = (lambda i: qg.quant_gemm_fused(
                x, wt_cold[i % len(wt_cold)], scale, **kw8))
            row("quant_gemm", cuda_ms(b9),
                cuda_ms(lambda i: qg.quant_gemm_plain(w, xt, **kw9), 5, 1),
                lib_ms, m * k + k * t + 4 * m * t, 2 * m * t * k, **shape)
            row("quant_gemm_fused", cuda_ms(b8),
                cuda_ms(lambda i: qg.quant_gemm_fused_plain(
                    x, wt, scale, **kw8), 5, 1),
                lib_ms, t * k + k * m + 4 * t * m + 4 * m, 2 * m * t * k,
                **shape)
            for src, rival in rivals.items() if t == 512 else ():
                # a rival wide design: checked and timed the same way,
                # beside the shipped one, on its own plan
                o9 = torch.empty((m, t), dtype=torch.int32, device=dev)
                o8 = torch.empty((t, m), dtype=torch.float32, device=dev)
                r9 = (lambda i: rival(w_cold[i % len(w_cold)], xt, o9))
                r8 = (lambda i: rival(x, wt_cold[i % len(wt_cold)], o8,
                                      scale))
                check("quant_gemm", r9(0), qg.quant_gemm_plain(
                    w_cold[0], xt, **kw9), True, f"plain, {src}, at {where}")
                check("quant_gemm_fused", r8(0), qg.quant_gemm_fused_plain(
                    x, wt_cold[0], scale, **kw8), True,
                    f"plain, {src}, at {where}")
                for name, call in (("quant_gemm", r9),
                                   ("quant_gemm_fused", r8)):
                    on_rival[src][name] += cuda_ms(call) * per_layer
            if t == 512:
                for name in wide_ms:
                    wide_ms[name] += per_kernel[name][-1]["ms"] * per_layer
                    wide_bound[name] += (per_kernel[name][-1]["bound_ms"]
                                         * per_layer)
                wide_lib += (lib_ms or 0.0) * per_layer
            del w_cold, wt_cold
    log(f"  wide kernel, one layer's seven calls at T=512 (ms): shipped "
        f"{json.dumps(wide_ms)}, rivals {json.dumps(on_rival)}, _int_mm "
        f"{wide_lib:.5f}, floor_ms {7 * floor_ms():.5f}, bound "
        f"{json.dumps(wide_bound)}")
    log(f"  quant_gemm, quant_gemm_fused: bit-identical to the plain "
        f"versions (with an activation within tolerance) at T in "
        f"{QUANT_TS}, both orientations, shapes {PATH_SHAPES} and ragged "
        f"{RAGGED_SHAPE[:2]}, both epilogue axes, with and without bias, "
        f"float32 and bfloat16")

    # two calls in a row on one stream, different operands, one sync:
    # neither result may depend on the other call
    m, k, _ = PATH_SHAPES[0]
    w = int8(m, k)
    wt = w.t().contiguous()
    scale = torch.rand((1, m), generator=gen, device=dev)
    for t in (4, 512):
        calls = []
        for _ in range(2):
            x = int8(t, k)
            xt = x.t().contiguous()
            sm = scale.t().contiguous()
            calls.append((x, xt,
                          qg.quant_gemm(w, xt, **whole(w, xt)),
                          qg.quant_gemm(x, wt, **whole(x, wt)),
                          qg.quant_gemm_fused(x, wt, scale, **whole(x, wt)),
                          qg.quant_gemm_fused(w, xt, sm, epilogue_axis="m",
                                              **whole(w, xt))))
        for i, (x, xt, g9a, g9b, g8b, g8a) in enumerate(calls):
            what = f"plain, call {i + 1} of two in a row at T={t}"
            check("quant_gemm", g9a,
                  qg.quant_gemm_plain(w, xt, **whole(w, xt)), True, what)
            check("quant_gemm", g9b,
                  qg.quant_gemm_plain(x, wt, **whole(x, wt)), True, what)
            check("quant_gemm_fused", g8b, qg.quant_gemm_fused_plain(
                x, wt, scale, **whole(x, wt)), True, what)
            check("quant_gemm_fused", g8a, qg.quant_gemm_fused_plain(
                w, xt, scale.t().contiguous(), epilogue_axis="m",
                **whole(w, xt)), True, what)

    # one device operation a call at every width (torch.profiler, one
    # session over every call)
    symbol = ("quant_rows_kernel", "quant_cols_kernel", "quant_wide_kernel")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    checks = []
    for t in QUANT_TS:
        x = int8(t, k)
        xt = x.t().contiguous()
        for orient, a, b in orientations(w, wt, x, xt):
            kern = symbol[qg.launch_plan(a.shape[0], b.shape[1], k,
                                         sms)["design"]]
            s = torch.rand((1, b.shape[1]), generator=gen, device=dev)
            kw = whole(a, b)
            where = f"M={m} K={k} T={t} {orient}"
            checks += [
                (f"quant_gemm {where}",
                 lambda a=a, b=b, kw=kw: qg.quant_gemm(a, b, **kw), kern),
                (f"quant_gemm_fused {where}",
                 lambda a=a, b=b, s=s, kw=kw: qg.quant_gemm_fused(a, b, s,
                                                                  **kw),
                 kern)]
    counts = one_device_op_each(checks)
    log(f"  quant_gemm, quant_gemm_fused: one device operation a call at "
        f"T in {QUANT_TS}, both orientations: {len(checks)} calls, "
        f"{json.dumps(counts)}")
    log(f"  quant_gemm layout: wrapper == library in "
        f"{quant_layout_agreement()} cases")
    return per_kernel, err


def kernel_api_pass(params, dev, log) -> dict:
    """Phase 5: the kernel-level ops API on every dense weight of the
    served model at the main path's planes=3 spec, one weight at a time.

    Per weight: the plan with encode_impl='kernel' (B7) equals the
    oracle's; B9 on the planned orientation equals B2 on the plan, and B8
    on the serving orientation equals B1, bit for bit (then both again
    with silu).  Returns the launch counts of the plain pass and of the
    silu pass, and the host seconds spent planning with each encoder."""
    import torch
    from repro_torch.core import quant
    from repro_torch.engine import QuantSpec
    from repro_torch.kernels import ops

    spec = QuantSpec.parse("planes=3,encoding=ent,act_quant=per_token,"
                           "impl=pallas_fused")

    def walk(node, out):
        if isinstance(node, list):
            for v in node:
                walk(v, out)
        elif isinstance(node, dict):
            w = node.get("w")
            if isinstance(w, torch.Tensor) and w.dim() == 2:
                out.append(w)
            for v in node.values():
                walk(v, out)
        return out
    weights = walk(params, [])
    gen = torch.Generator(device=dev).manual_seed(314)
    plan_s = {"kernel": 0.0, "ref": 0.0}
    passes = {"plain": dict.fromkeys(KERNELS, 0),
              "silu": dict.fromkeys(KERNELS, 0)}
    silu_diff = 0.0
    silu_equal = True

    def tally(which, before):
        for name, count in read_counts().items():
            passes[which][name] += count - before[name]

    zero_counts()
    for idx, w in enumerate(weights):
        k, n = w.shape
        qw, sw = quant.quantize_for_spec(w.to(torch.float32), spec, axis=0)
        bm, bk, _ = ops.select_block_sizes(n, k, 128, spec)
        before = read_counts()
        plans = {}
        # alternate which encoder plans first, so neither always finds
        # the weight in L2
        for impl in (("kernel", "ref") if idx % 2 == 0 else ("ref",
                                                             "kernel")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plans[impl] = ops.plan_operand(qw.t(), spec.encoding, bm, bk,
                                           encode_impl=impl, bits=spec.bits)
            torch.cuda.synchronize()
            plan_s[impl] += time.perf_counter() - t0
        planned = plans["kernel"]
        for field in ("digits", "mask", "schedule", "row_perm", "inv_perm"):
            if not torch.equal(getattr(planned, field),
                               getattr(plans["ref"], field)):
                raise AssertionError(f"weight {idx} {tuple(w.shape)}: "
                                     f"kernel-encoded plan's {field} != "
                                     f"the oracle's")
        del plans
        x = torch.randn((4, k), generator=gen, device=dev)
        xq, _ = quant.quantize_for_spec(x, spec, axis=-1)     # per token
        # B8 has no per-token axis: its scale is sw times the per-tensor
        # activation scale of the same x (the check is the identity of
        # the two kernels)
        _, sx = quant.quantize_for_spec(x, spec)
        s = (sw.reshape(-1) * sx).contiguous()
        got9 = ops.quant_gemm(qw.t(), xq.t())
        got2 = ops.bw_gemm(planned, xq.t())
        got8 = ops.quant_gemm_fused(xq, qw, s).t()
        got1 = ops.bw_gemm_fused(planned, xq.t(), s)
        torch.cuda.synchronize()
        if not torch.equal(got9, got2):
            raise AssertionError(f"weight {idx} {tuple(w.shape)}: "
                                 f"quant_gemm != bw_gemm")
        if not torch.equal(got8, got1):
            raise AssertionError(f"weight {idx} {tuple(w.shape)}: "
                                 f"quant_gemm_fused != bw_gemm_fused")
        tally("plain", before)
        before = read_counts()
        got8 = ops.quant_gemm_fused(xq, qw, s, activation="silu").t()
        got1 = ops.bw_gemm_fused(planned, xq.t(), s, activation="silu")
        torch.cuda.synchronize()
        tally("silu", before)
        silu_diff = max(silu_diff, float((got8 - got1).abs().max()))
        silu_equal = silu_equal and torch.equal(got8, got1)
        if not bool(torch.all((got8 - got1).abs()
                              <= ACT_ATOL + ACT_RTOL * got1.abs())):
            raise AssertionError(f"weight {idx} {tuple(w.shape)}: silu "
                                 f"quant_gemm_fused != bw_gemm_fused")
        del planned, got9, got2, got8, got1
    return {"weights": len(weights), "launches": passes,
            "plan_s": plan_s, "silu_max_abs_diff": silu_diff,
            "silu_bit_identical": silu_equal}


def device_events(prof) -> list:
    """(name, device ns) of every device event (kernels, copies, sets) of
    a finished torch.profiler session, read from its raw kineto events:
    the profiler's Python events (``key_averages``, ``events``) take
    about ten times as long to build, longer than the calls profiled."""
    def ns(e):
        f = getattr(e, "duration_ns", None)
        return f() if f is not None else 1000 * e.duration_us()
    return [(e.name(), ns(e)) for e in prof.profiler.kineto_results.events()
            if str(e.device_type()).endswith("CUDA")
            and e.name() != MOE_RANGE]      # phase 9's range on the card


def profile_step(eng, dev) -> None:
    """One decode step of a served engine, its tokens read back."""
    import torch
    with torch.no_grad():
        logits, _ = eng.api.decode_step(
            eng.params, torch.as_tensor(eng.slots.cur, device=dev),
            torch.as_tensor(eng.slots.pos, device=dev), eng.state, eng.cfg)
        torch.argmax(logits[:, -1, :], dim=-1).cpu()


def profile_steps(eng, dev, steps: int = 3) -> dict:
    """torch.profiler over ``steps`` decode steps of a served engine
    (``profile_calls``)."""
    return profile_calls(lambda: profile_step(eng, dev), steps)[0]


def profile_calls(fn, steps: int = 1, host: bool = False,
                  warmed: bool = False):
    """torch.profiler over ``steps`` fn() calls, after one unprofiled
    call (none if ``warmed``: the caller has just made one): the device
    time a call (every device event), each bw_gemm kernel's part of it
    and its device operations a call, and the costliest kernels
    (``device_events``).  The device's activity only, unless ``host``:
    then the host's too, for a ``record_function`` range's device time
    (``moe_experts_profile``).  Returns (that dict, the profile)."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not warmed:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA] +
                 ([ProfilerActivity.CPU] if host else [])) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    us, count = collections.Counter(), collections.Counter()
    for name, ns in device_events(prof):
        us[name] += ns / 1e3
        count[name] += 1
    top = sorted(us, key=us.get, reverse=True)[:12]
    return {"steps": steps,
            "device_ms_per_step": sum(us.values()) / 1e3 / steps,
            "kernel_launches_per_step": sum(count.values()) / steps,
            "kernel_ms_per_step": {
                k: sum(v for n, v in us.items() if k in n) / 1e3 / steps
                for k in set(SYMBOLS.values())},
            "kernel_ops_per_step": {
                k: sum(v for n, v in count.items() if k in n) / steps
                for k in set(SYMBOLS.values())},
            "top_kernels": [(n[:90], us[n] / 1e3 / steps, count[n] / steps)
                            for n in top]}, prof


# served kernel -> its CUDA symbol in profiler events
SYMBOLS = {"bw_gemm_fused": "bw_gemm_fused_kernel",
           "bw_gemm": "bw_gemm_i32_kernel",
           "bw_gemm_sparse_fused": "sparse_fused_kernel",
           "bw_gemm_sparse": "sparse_i32_kernel",
           "bw_gemm_sparse_fused_pipelined": "pipelined_kernel"}


def serve(cfg, params, spec_text, prompts, dev):
    import torch
    from repro_torch.engine import QuantSpec
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.request import ServeRequest

    t0 = time.perf_counter()
    eng = ServeEngine(cfg, 4, 64, quant=QuantSpec.parse(spec_text),
                      params=params, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reqs = [ServeRequest(i, list(p), 16) for i, p in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    stats = eng.run(reqs)
    launches = read_counts()
    stats.update(setup_s=setup_s, launches=launches,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 ms_per_step=1e3 * stats["wall_s"] / stats["engine_steps"],
                 plan_stats=eng.plan_stats)
    # one more decode step: the logits are finite and of the right shape
    with torch.no_grad():
        logits, _ = eng.api.decode_step(
            eng.params, torch.as_tensor(eng.slots.cur, device=dev),
            torch.as_tensor(eng.slots.pos, device=dev), eng.state, eng.cfg)
    if tuple(logits.shape) != (4, 1, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{spec_text}: bad logits "
                             f"{tuple(logits.shape)}")
    try:
        prof = profile_steps(eng, dev)
        prof["device_busy_share"] = \
            prof["device_ms_per_step"] / stats["ms_per_step"]
        stats["profile"] = prof
    except (RuntimeError, AttributeError) as e:   # tracer unavailable
        stats["profile"] = {"error": repr(e)}
    tokens = [r.out for r in reqs]
    if spec_text.endswith(("pallas_sparse", "pallas_pipelined")):
        stats["unfused"] = unfused_routes(eng, dev)
    del eng, logits
    free_device_memory()
    return tokens, stats


def unfused_routes(eng, dev) -> dict:
    """B4 / B6, the unfused twins, on a served engine's planned weights:
    every weight's record through planned_dense_apply(fused=False) on the
    engine's sparse route (dispatch 'sparse' on m_major plans, 'pipelined'
    on k_major ones), held bit-identical to the dense route (B2) on the
    same record and batch-4 activations.  Returns the launch counts."""
    import torch
    from repro_torch.kernels import ops

    order = "k_major" if eng.spec.impl == "pallas_pipelined" else "m_major"
    route = "pipelined" if order == "k_major" else "sparse"
    gen = torch.Generator(device=dev).manual_seed(99)

    # records is passed down, not closed over: the recursive closure's
    # reference cycle must not keep the engine's plans alive
    def walk(node, records):
        if isinstance(node, list):
            for v in node:
                walk(v, records)
        elif isinstance(node, dict):
            if "w_plan" in node:
                records.append((node["w_plan"], node["w"].shape))
            for key, v in node.items():
                if key != "w_plan":
                    walk(v, records)
        return records
    records = walk(eng.params, [])
    outs = []
    zero_counts()
    for plan, (k, n_out) in records:
        x = torch.randn((4, k), generator=gen, device=dev)
        outs.append((plan, x, n_out, ops.planned_dense_apply(
            plan, x, eng.spec, n_out, fused=False, dispatch=route,
            order=order)))
    launches = read_counts()
    for plan, x, n_out, got in outs:
        want = ops.planned_dense_apply(plan, x, eng.spec, n_out,
                                       fused=False, dispatch="dense")
        if not torch.equal(got, want):
            raise AssertionError(f"unfused {route} route != dense route")
    return {"route": route, "weights": len(records), "launches": launches}


def server_requests(cfg, n: int = 8, prompt_len=(8, 24),
                    max_tokens: int = 16):
    """Phase 6's traffic: 8 seeded prompts of 8-24 tokens, 16 new tokens
    each, Poisson arrivals (loadgen's, 8 requests a second, seed 0)."""
    from repro_torch.serving import loadgen
    return loadgen.synthesize(cfg.vocab_size, n, prompt_len=prompt_len,
                              max_tokens=(max_tokens, max_tokens),
                              pattern="poisson", rate=8.0, seed=0)


def pctl(values, q) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(list(values), np.float64), q))


def free_device_memory() -> None:
    import gc
    import torch
    from repro_torch.kernels import ops
    ops.plan_cache_clear()
    gc.collect()
    torch.cuda.empty_cache()


# Phase 6's layers: the first eighth of minicpm-2b's 40, at full width,
# so that the script stays inside its time limit (PERF.md §4, §6)
SERVER_DEPTH = 5
# Phases 10-12's layers: the first quarter of each config's 32, at full
# width, for the script's time (PERF.md §4).  The params are drawn whole
# and cut after, so that the layers the decode gates read
# (RWKV_GATE_DEPTH, HYMBA_GATE_DEPTH) and the head hold the weights the
# gates were set on.
CONFIG_DEPTH = 8


def first_layers(cfg, params, depth: int):
    """(cfg, params) cut to their first ``depth`` layers."""
    depth = min(depth, cfg.n_layers)
    return (cfg.replace(n_layers=depth),
            dict(params, blocks=params["blocks"][:depth]))


def server_phase(cfg, params, dev, log, kind) -> dict:
    """Phase 6: the serving stack on a full-width model, every worker
    on the one float tree ``params``.

    (a) Virtual mode, the default ladder's two tiers (fast planes=2,
    quality planes=4, both pallas_fused, per-token), routed round robin
    so both serve: every request completes, and B1 is launched 7 * layers
    * the workers' steps, every other kernel never.  (b) Realtime mode,
    the same traffic on the same server (each engine warmed before the
    clock starts; the watchdog's miss limit is 50 EWMA steps): the same
    tiers and tokens, and tok/s, TTFT/TPOT p50/p99 and peak GB on the
    host clock.  Every request's tokens equal a standalone
    ``ServeEngine.run`` of its tier's spec.  (c) Failover: twin planes=3
    tiers a and b, restore mode; a virtual run of the traffic picks the
    first pump of ``a`` after which one of its slots is past its prompt,
    ``a`` is killed there (asserted at the kill), and every request
    completes with the uninterrupted tokens, restored >= 1 and
    reprefilled 0."""
    import torch
    from repro_torch.engine import QuantSpec
    from repro_torch.serving import (AsyncServer, ServeEngine,
                                     ServeRequest, Tier, default_tiers,
                                     validate_summary)

    out = {}
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = AsyncServer(cfg, tiers=default_tiers(2, batch=4), max_len=64,
                         router="round_robin", watchdog_miss_limit=50,
                         params=params, device=dev)
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t0
    runs = {}
    for mode in ("virtual", "realtime"):
        reqs = server_requests(cfg)
        torch.cuda.synchronize()
        zero_counts()
        stats = validate_summary(server.run(reqs,
                                            realtime=mode == "realtime"))
        launches = read_counts()
        if stats["completed"] != 8 or any(len(r.out) != 16 for r in reqs):
            raise AssertionError(f"server {mode}: {stats['completed']} of 8"
                                 f" requests completed with 16 tokens")
        if stats["failover"]["worker_deaths"]:
            raise AssertionError(f"server {mode}: a worker died: "
                                 f"{stats['failover']}")
        runs[mode] = (reqs, stats, launches)
    reqs, stats, launches = runs["virtual"]
    want = 7 * cfg.n_layers * stats["engine_steps"]
    expect = {name: want if name == "bw_gemm_fused" else 0
              for name in KERNELS}
    if launches != expect:
        raise AssertionError(f"server virtual: launches {launches}, "
                             f"expected {expect}")
    if set(stats["tier_requests"]) != {"fast", "quality"}:
        raise AssertionError(f"server: tiers served {stats['tier_requests']}")
    v_tiers = [(r.rid, r.tier) for r in reqs]
    r_reqs, r_stats, _ = runs["realtime"]
    if [(r.rid, r.tier) for r in r_reqs] != v_tiers:
        raise AssertionError("server: realtime routed otherwise than virtual")
    peak_server = torch.cuda.max_memory_allocated() / 1e9
    # the device's busy share while serving in realtime: a short load (a
    # request a tier) under torch.profiler gives the kernels' device time
    # a worker step, set against run (b)'s served window (its sim_s, the
    # clock TTFT/TPOT and tok/s read; a step's device work is the same at
    # any occupancy: the batch is 4).  Run (b) warmed the engines and a
    # warm runs once an engine, so the profiled run holds no warm step.
    from torch.profiler import ProfilerActivity, profile
    if not all(w.engine.warmed for w in server.workers.values()):
        raise AssertionError("server: an engine was not warmed by run (b)")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        p_stats = server.run(server_requests(cfg, 2, (8, 8), 4),
                             realtime=True)
    dev_ms = sum(ns for _, ns in device_events(prof)) / 1e6
    dev_ms_step = dev_ms / p_stats["engine_steps"]
    busy = dev_ms_step * r_stats["engine_steps"] / (1e3 * r_stats["sim_s"])
    out.update(virtual=stats, virtual_launches=launches,
               realtime=r_stats, server_peak_gb=peak_server)
    tier_specs = {t.name: t.spec for t in server.tiers}
    del server
    free_device_memory()
    for name, spec in tier_specs.items():
        mine = [r for r in reqs if r.tier == name]
        clones = [ServeRequest(r.rid, list(r.prompt), r.max_tokens)
                  for r in mine]
        eng = ServeEngine(cfg, 4, 64, quant=spec, params=params,
                          device=dev)
        eng.run(clones)
        del eng
        free_device_memory()
        alone = {c.rid: c.out for c in clones}
        for mode, (rs, _, _) in runs.items():
            got = {r.rid: r.out for r in rs if r.tier == name}
            if got != alone:
                raise AssertionError(f"server {mode}: tier {name} tokens "
                                     f"differ from a standalone engine")
    out["realtime_metrics"] = {
        "tok_per_s": r_stats["tok_per_s"], "wall_s": r_stats["wall_s"],
        "sim_s": r_stats["sim_s"],
        "ttft_p50_s": pctl((r.ttft for r in r_reqs), 50),
        "ttft_p99_s": pctl((r.ttft for r in r_reqs), 99),
        "tpot_p50_s": pctl((r.tpot for r in r_reqs), 50),
        "tpot_p99_s": pctl((r.tpot for r in r_reqs), 99),
        "engine_steps": r_stats["engine_steps"],
        "per_step_s": r_stats["per_step_s"], "peak_gb": peak_server,
        "device_ms_per_worker_step": dev_ms_step,
        "device_busy_share": busy}
    log(f"[server] virtual --tiers 2 (fast planes=2, quality planes=4): "
        f"{stats['completed']} requests, {stats['generated_tokens']} tokens"
        f", {stats['engine_steps']} worker steps, tiers "
        f"{stats['tier_requests']}, launches {json.dumps(launches)}; "
        f"modelled sim_s {stats['sim_s']} (cost model, not the card)")
    log(f"[server] realtime --tiers 2: {json.dumps(out['realtime_metrics'])}"
        f"; set-up {out['setup_s']:.1f} s  ({kind})")
    log("[server] virtual and realtime: every request's tokens equal a "
        "standalone ServeEngine.run of its tier's spec")

    # (c) failover between twin planes=3 tiers
    spec3 = QuantSpec.parse("planes=3,encoding=ent,impl=pallas_fused,"
                            "act_quant=per_token")
    twins = (Tier("a", spec3, 4), Tier("b", spec3, 4))
    server = AsyncServer(cfg, tiers=twins, max_len=64, router="round_robin",
                         failover="restore", params=params, device=dev)
    worker = server.workers["a"]
    ready_after = []
    pump = worker.pump

    def watched_pump(now, t_end=None):
        fin = pump(now, t_end)
        slots = worker.engine.slots
        ready_after.append(any(r.out and slots.decode_ready(s)
                               for s, r in slots.bound()))
        return fin
    worker.pump = watched_pump
    healthy = server_requests(cfg)
    server.run(healthy)
    worker.pump = pump
    expect_out = {r.rid: r.out for r in healthy}
    kill_at = next((i + 1 for i, ok in enumerate(ready_after) if ok), None)
    if kill_at is None:
        raise AssertionError("failover: no pump of a leaves a slot past "
                             "its prompt")
    drain = worker.drain
    at_kill = []

    def checked_drain(snapshots=False):
        slots = worker.engine.slots
        at_kill.append([(r.rid, len(r.out)) for s, r in slots.bound()
                        if r.out and slots.decode_ready(s)])
        if not at_kill[-1]:
            raise AssertionError("failover: no slot of a is past its "
                                 "prompt at the kill")
        return drain(snapshots)
    worker.drain = checked_drain
    server.chaos = f"kill:a@s{kill_at}"
    reqs = server_requests(cfg)
    stats = validate_summary(server.run(reqs))
    fo = stats["failover"]
    if stats["completed"] != 8 or fo["lost"] or fo["worker_deaths"] != 1:
        raise AssertionError(f"failover: {stats['completed']} completed, "
                             f"{fo}")
    if fo["restored"] < 1 or fo["reprefilled"] != 0:
        raise AssertionError(f"failover: restored {fo['restored']}, "
                             f"reprefilled {fo['reprefilled']}")
    if {r.rid: r.out for r in reqs} != expect_out:
        raise AssertionError("failover: tokens differ from the "
                             "uninterrupted run")
    out["failover"] = dict(fo, kill_at=kill_at, at_kill=at_kill[0])
    log(f"[server] failover: twin planes=3 tiers, a killed before its pump "
        f"{kill_at} with {at_kill[0]} (rid, tokens) past the prompt; every "
        f"request completes with the uninterrupted tokens; "
        f"{json.dumps(fo)}")
    del server, worker
    free_device_memory()
    return out


# Phase 7: the plane budgets of the default ladder's tiers (the sweep's)
TUNED_PLANES = (2, 3, 4)
# route planned_dense_apply resolves -> the fused kernel it launches
ROUTE_KERNELS = {"dense": "bw_gemm_fused", "sparse": "bw_gemm_sparse_fused",
                 "pipelined": "bw_gemm_sparse_fused_pipelined"}


def model_weights(params) -> list:
    """Every dense weight [d_in, d_out] of a param tree, in tree order."""
    import torch

    def walk(node, out):
        if isinstance(node, list):
            for v in node:
                walk(v, out)
        elif isinstance(node, dict):
            w = node.get("w")
            if isinstance(w, torch.Tensor) and w.dim() == 2:
                out.append(w)
            for v in node.values():
                walk(v, out)
        return out
    return walk(params, [])


def verified_planning(params, dev, log, kind) -> dict:
    """Phase 7 (a): every weight planned at planes=3 m_major with and
    without verification (host seconds each), the three shapes also
    k_major; every verified schedule in the memo; the cost cross-check
    clean on one plan of each shape and order."""
    import torch
    from repro_torch import analysis
    from repro_torch.engine import QuantSpec
    from repro_torch.kernels import ops

    spec = QuantSpec.parse("planes=3,encoding=ent,act_quant=per_token,"
                           "impl=pallas_fused")
    weights = model_weights(params)
    secs = {}
    firsts = {}
    for verify in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for w in weights:
            rec = ops.plan_dense_weight(w, spec, use_cache=False,
                                        verify=verify)
            if verify and not ops._schedule_verified(rec["schedule"]):
                raise AssertionError(f"{tuple(w.shape)}: a verified plan's "
                                     f"schedule is not in the memo")
            if verify:
                firsts.setdefault(tuple(w.shape), (w, rec))
        torch.cuda.synchronize()
        secs[verify] = time.perf_counter() - t0
    report = analysis.Report("phase 7 cost cross-check")
    for (k, n_out), (w, rec) in firsts.items():
        for impl in ("pallas_fused", "pallas_sparse"):
            analysis.crosscheck_cost(impl, n_out, k, 4, spec, rec,
                                     report=report)
        krec = ops.plan_dense_weight(w, spec, use_cache=False,
                                     order="k_major", verify=True)
        if not ops._schedule_verified(krec["schedule"]):
            raise AssertionError(f"{(k, n_out)} k_major: not verified")
        analysis.crosscheck_cost("pallas_pipelined", n_out, k, 4, spec,
                                 krec, report=report)
    if report.diagnostics:
        raise AssertionError(f"cost cross-check: {report}")
    out = {"weights": len(weights), "shapes": sorted(firsts),
           "plan_s": secs[False], "plan_verified_s": secs[True]}
    log(f"[analysis] {len(weights)} weights planned at planes=3 m_major "
        f"with verify=True: every schedule verified (zero error "
        f"diagnostics: none raised) and in the memo; the {len(firsts)} "
        f"shapes {sorted(firsts)} also k_major; crosscheck_cost clean for "
        f"pallas_fused and pallas_sparse (m_major) and pallas_pipelined "
        f"(k_major); host s to plan all {len(weights)}: "
        f"{secs[False]:.3f} without verification, {secs[True]:.3f} with  "
        f"({kind})")
    return out


def seam_host_cost(params, dev, log, kind, calls: int = 20_000) -> dict:
    """Phase 7 (a'): host us a call of the seams this slice put on the
    served path, on a planes=2 plan of the first 2304x2304 weight on the
    card, the checked-in cache (every card lookup misses): the 'auto'
    dispatch (cache probe, then the threshold), the threshold alone (the
    resolution 'auto' had before the cache), a fixed route, and the
    pre-kernel verification seam with REPRO_VERIFY unset.  Best of three
    loops of ``calls``."""
    import os
    from repro_torch.engine import QuantSpec
    from repro_torch.kernels import autotune, ops

    if os.environ.get(autotune.ENV_VAR) or ops.verification_enabled():
        raise AssertionError("seam cost: REPRO_AUTOTUNE_CACHE or "
                             "REPRO_VERIFY is set")
    autotune.reset_cache()
    spec = QuantSpec.parse("planes=2,encoding=ent,act_quant=per_token,"
                           "impl=pallas_sparse")
    w = model_weights(params)[0]
    k, n_out = w.shape
    rec = ops.plan_dense_weight(w, spec, use_cache=False, verify=False)

    def threshold():
        density = rec["schedule"].shape[0] / max(rec["mask"].numel(), 1)
        return "sparse" if density <= ops.SPARSE_DENSITY_THRESHOLD \
            else "dense"

    seams = {
        "auto": lambda: ops._resolve_dispatch("auto", rec, spec, n_out, k,
                                              4, "m_major"),
        "threshold_only": threshold,
        "fixed_route": lambda: ops._resolve_dispatch(
            "sparse", rec, spec, n_out, k, 4, "m_major"),
        "verify_seam": lambda: ops._maybe_verify_plan(rec, spec, "m_major",
                                                      None)}
    density = rec["schedule"].shape[0] / max(rec["mask"].numel(), 1)
    if autotune.get_cache().lookup(n_out, k, 4, spec, density=density,
                                   device=rec["schedule"].device) is None \
            and seams["auto"]() != threshold():
        raise AssertionError("seam cost: 'auto' left the threshold's route "
                             "on a miss")
    us = {}
    for name, fn in seams.items():
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            best = min(best, time.perf_counter() - t0)
        us[name] = 1e6 * best / calls
    added = us["auto"] - us["threshold_only"] + us["verify_seam"]
    out = {"us_per_call": us, "added_us_per_call": added,
           "added_ms_per_step": 7 * 40 * added / 1e3, "shape": [k, n_out]}
    log(f"[analysis] host us a call, {calls} calls best of 3, {k}x{n_out} "
        f"planes=2 plan: {json.dumps(us)}; added on the served 'auto' "
        f"route (auto - threshold_only + verify_seam) {added:.3f} us a "
        f"call, {out['added_ms_per_step']:.4f} ms a step of 280 calls  "
        f"({kind})")
    autotune.reset_cache()
    return out


def tuned_shapes(cfg) -> tuple:
    """(M, K) of the model's three projection shapes: attention, up/gate,
    down (kernel rows M = output channels)."""
    return ((cfg.d_model, cfg.d_model), (cfg.d_ff, cfg.d_model),
            (cfg.d_model, cfg.d_ff))


def footprint_agreement(cfg, log) -> int:
    """Phase 7 (b): for every candidate block shape of the sweep, the
    shared-memory pass's pipelined footprint equals the library's layout
    at N=4 (fits exactly when the library lays it out, with equal smem)."""
    from repro_torch import analysis
    from repro_torch.kernels import autotune
    from repro_torch.kernels import bw_gemm as bwk

    checked = 0
    for m, k in tuned_shapes(cfg):
        for c in autotune.candidate_configs(m, k, 4):
            parts = analysis.vmem_footprint(
                "pipelined", m, k, 4, block_m=c["block_m"],
                block_k=c["block_k"], block_n=c["block_n"], n_planes=4)
            lay = bwk.pipelined_layout_of_kernel(4, c["block_m"],
                                                 c["block_k"])
            fits = "refused" not in parts and \
                parts["total"] <= analysis.vmem_budget()
            if fits != (lay is not None) or \
                    (lay is not None and parts["total"] != lay["smem"]):
                raise AssertionError(f"{m}x{k} {c}: footprint {parts} != "
                                     f"the library's layout {lay}")
            checked += 1
    log(f"[autotune] shared-memory pass == csrc layout on {checked} "
        f"candidates (N=4)")
    return checked


def tuned_sweep(cfg, dev, log, kind, path) -> dict:
    """Phase 7 (c): autotune_gemm at the three projection shapes, N=4, for
    each plane budget of TUNED_PLANES, timed on the card; every candidate
    and winner logged; the winners saved to the cache file ``path``."""
    from repro_torch.engine import QuantSpec
    from repro_torch.kernels import autotune

    cache = autotune.AutotuneCache(str(path))
    timed = []
    winners = {}
    t0 = time.perf_counter()
    for m, k in tuned_shapes(cfg):
        for planes in TUNED_PLANES:
            rows = []
            win = autotune.autotune_gemm(
                m, k, 4, QuantSpec(planes=planes), cache=cache, iters=24,
                device=dev,
                on_measure=lambda c, sec: rows.append((c, sec)))
            timed.extend(rows)
            winners[f"{m}x{k} planes={planes}"] = win
            cands = "; ".join(
                f"{c['dispatch']}/{c['order']} {c['block_m']}x"
                f"{c['block_k']} {1e6 * sec:.2f}" for c, sec in rows)
            log(f"[autotune] {m}x{k}x4 planes={planes}: us a call: "
                f"{cands}  ({kind})")
            log(f"[autotune] {m}x{k}x4 planes={planes} winner: "
                f"{json.dumps(win)}")
    sweep_s = time.perf_counter() - t0
    cache.save()
    problems = autotune.validate(autotune.DEFAULT_CACHE_PATH)
    if problems:
        raise AssertionError(f"checked-in autotune cache: {problems}")
    want = len(TUNED_PLANES) * sum(
        len(autotune.candidate_configs(m, k, 4)) for m, k in tuned_shapes(cfg))
    if len(timed) != want:
        raise AssertionError(f"sweep timed {len(timed)} candidates, "
                             f"expected {want}")
    log(f"[autotune] {len(timed)} candidates timed in {sweep_s:.1f} s; "
        f"{len(cache.entries)} entries saved to a temporary cache file; "
        f"the checked-in cache validates")
    return {"winners": winners, "candidates": len(timed),
            "sweep_s": sweep_s, "entries": dict(cache.entries)}


def expected_routes(cfg, entries, kind, plans) -> dict:
    """The route each projection of a planes=2 m_major engine takes under
    a measured cache, read from the cache's entries: the density-bucket
    entry, else the shape entry, of (n_out, K, 4); a dense winner takes
    B1, a sparse-route winner measured on m_major schedules its own
    route; any other (no entry, or a k_major-measured winner) leaves the
    0.5 threshold to decide."""
    from repro_torch.kernels import autotune

    routes = {}
    for name, (plan, k, n_out) in plans.items():
        density = plan["schedule"].shape[0] / plan["mask"].numel()
        key = f"{n_out}x{k}x4|p2.ent8|{kind}"
        hit = entries.get(f"{key}|d{autotune.density_bucket(density)}") \
            or entries.get(key)
        if hit is not None and hit["dispatch"] == "dense":
            routes[name] = ("dense", hit)
        elif hit is not None and hit["order"] == "m_major":
            routes[name] = (hit["dispatch"], hit)
        else:
            routes[name] = ("sparse" if density <= 0.5 else "dense", hit)
    return routes


def serve_counted(cfg, params, spec_text, prompts, dev) -> dict:
    """Serve ``prompts`` on a fresh engine: its tokens, launches, steps,
    plan_stats, the first layer's record of each projection and the
    autotune cache's lookup counts over the engine's life."""
    import torch
    from repro_torch.engine import QuantSpec
    from repro_torch.kernels import autotune
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.request import ServeRequest

    cache = autotune.get_cache()
    hits, misses = cache.hits, cache.misses
    eng = ServeEngine(cfg, 4, 64, quant=QuantSpec.parse(spec_text),
                      params=params, device=dev)
    reqs = [ServeRequest(i, list(p), 16) for i, p in enumerate(prompts)]
    zero_counts()
    stats = eng.run(reqs)
    launches = read_counts()
    torch.cuda.synchronize()
    layer0 = eng.params["blocks"][0]
    plans = {}
    for group, names in (("attn", ("wq", "wk", "wv", "wo")),
                         ("mlp", ("up", "gate", "down"))):
        for name in names:
            node = layer0[group][name]
            plans[name] = (node["w_plan"], *node["w"].shape)
    out = {"tokens": [r.out for r in reqs], "launches": launches,
           "steps": stats["engine_steps"], "plan_stats": eng.plan_stats,
           "plans": plans, "hits": cache.hits - hits,
           "misses": cache.misses - misses}
    del eng
    return out


def tuned_serving(cfg, params, dev, log, kind, prompts, want_tokens,
                  path, entries) -> dict:
    """Phase 7 (d) and (e): planes=2 pallas_sparse (dispatch 'auto') on 3
    prompts, first with REPRO_AUTOTUNE_CACHE naming the sweep's file --
    each projection launches the kernel of the route expected_routes reads
    from it -- then with no env var: B3 everywhere, no lookup hit.  Both
    emit phase 4's planes=2 tokens."""
    import os
    from repro_torch.kernels import autotune

    spec = "planes=2,encoding=ent,act_quant=per_token,impl=pallas_sparse"
    out = {}
    for tuned in (True, False):
        if tuned:
            os.environ[autotune.ENV_VAR] = str(path)
        else:
            os.environ.pop(autotune.ENV_VAR, None)
        autotune.reset_cache()
        run = serve_counted(cfg, params, spec, prompts, dev)
        if run["tokens"] != want_tokens:
            raise AssertionError(f"phase 7 tuned={tuned}: tokens differ "
                                 f"from phase 4's planes=2 tokens")
        calls = cfg.n_layers * run["steps"]
        if tuned:
            routes = expected_routes(cfg, entries, kind, run["plans"])
        else:
            routes = {name: ("sparse", None) for name in run["plans"]}
        expect = dict.fromkeys(KERNELS, 0)
        for route, _hit in routes.values():
            expect[ROUTE_KERNELS[route]] += calls
        if run["launches"] != expect:
            raise AssertionError(f"phase 7 tuned={tuned}: launches "
                                 f"{run['launches']}, expected {expect} "
                                 f"from routes {routes}")
        if not tuned and run["hits"]:
            raise AssertionError(f"phase 7 without the env var: "
                                 f"{run['hits']} cache hits")
        label = "REPRO_AUTOTUNE_CACHE set" if tuned else "no env var"
        log(f"[autotune] planes=2 pallas_sparse, {label}: routes "
            f"{ {n: r for n, (r, _h) in routes.items()} }; launches "
            f"{json.dumps({n: c for n, c in run['launches'].items() if c})}"
            f" over {run['steps']} steps; cache hits {run['hits']}, misses "
            f"{run['misses']}; schedules_verified "
            f"{run['plan_stats']['schedules_verified']}; tokens equal "
            f"phase 4's  ({kind})")
        out["tuned" if tuned else "untuned"] = {
            "routes": {n: r for n, (r, _h) in routes.items()},
            "launches": run["launches"], "steps": run["steps"],
            "hits": run["hits"], "misses": run["misses"],
            "schedules_verified": run["plan_stats"]["schedules_verified"]}
        del run
        free_device_memory()
    autotune.reset_cache()
    return out


def autotune_phase(cfg, params, dev, log, kind, prompts,
                   want_tokens) -> dict:
    """Phase 7: the static analyzers and the measured autotuner on the
    full-width model ((a)-(e), see the module docstring)."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    out = {"planning": verified_planning(params, dev, log, kind),
           "seams": seam_host_cost(params, dev, log, kind)}
    free_device_memory()
    out["footprints"] = footprint_agreement(cfg, log)
    tmp = Path(tempfile.mkdtemp(prefix="autotune-"))
    try:
        path = tmp / "autotune_cache.json"
        sweep = tuned_sweep(cfg, dev, log, kind, path)
        out["sweep"] = {k: v for k, v in sweep.items() if k != "entries"}
        free_device_memory()
        out["serving"] = tuned_serving(cfg, params, dev, log, kind, prompts,
                                       want_tokens, path, sweep["entries"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    return out


# Phase 8: the full-sequence forward and the dense configs.  (batch,
# tokens) of the forward: N = 256 on the plain causal path, N = 4,096 on
# the chunked one (4,096 > attn_chunk 2,048)
FORWARD_SIZES = ((4, 64), (1, 4096))
# forward route -> the kernel each projection launches
FORWARD_ROUTES = {"pallas_fused": "bw_gemm_fused", "pallas": "bw_gemm",
                  "planes": None}
PREFILL_TOKENS = 48                  # then decode to the 64th token
# prefill + decode against the forward: the largest logit gap allowed
# (also the top-2 margin under which a greedy token may flip) and the
# mean gap allowed.  The card's float32 sums in attention and the norms
# are ordered by shape, so a decode step's hidden state can round one ulp
# from the forward's, and 40 layers of per-token quantization grow that.
# Measured on this seed (4 x 64 tokens, pallas_fused; NVIDIA H100 80GB
# HBM3): sound, largest 2.777 and mean 0.148; decode positions one
# ahead, 4.547 and 0.598; the prompt's last K/V dropped, 4.055 and 0.543;
# each layer given the next one's cache, 42.9 and 6.10 (PERF.md §6)
PREFILL_LOGIT_ATOL, PREFILL_MEAN_ATOL = 4.0, 0.3
WIDE_NS = (256, 4096)                # the forward's N, for B1/B2 alone
# config -> layers run.  A planned projection holds its float32 weight
# and four int8 digit planes, about 8 bytes a parameter, and one card's
# 80 GB holds 16, 4 and 8 layers beside the embedding and the planned
# untied head; an eighth of that, or one layer, keeps the script inside
# its time limit with phases 10 and 11 (PERF.md §4).  Widths, heads,
# vocabulary and activation are the published ones.
DENSE_DEPTHS = {"nemotron-4-15b": 2, "qwen1.5-110b": 1, "granite-34b": 1}
DENSE_NEW_TOKENS, DENSE_MAX_LEN = 8, 32


def spec_of(impl: str):
    """Phase 8's spec: the main path's, on route ``impl``."""
    from repro_torch.engine import QuantSpec
    return QuantSpec.parse(f"planes=3,encoding=ent,act_quant=per_token,"
                           f"impl={impl}")


def hold_b1_b2(digits, mask, scale, bias, x, acts, calls, what, **kw):
    """B2 and B1 (under each of ``acts``) on one planned weight and the
    float32 tokens ``x`` [N, K_pad], quantized per token at planes=3,
    against their plain versions: B2 and B1 without an activation bit
    for bit, with one within ACT_RTOL / ACT_ATOL.  Adds the calls to
    ``calls``."""
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels import bw_gemm as bwk
    from repro_torch.kernels import ops

    qx, sx = quant.quantize_to_planes(x, 3, axis=-1)
    b = ops._pad_to(qx, kw["block_k"], 1).contiguous()
    got = bwk.bw_gemm(digits, b, mask, **kw)
    if not torch.equal(got, bwk.bw_gemm_plain(digits, b, mask, **kw)):
        raise AssertionError(f"bw_gemm != plain at {what}")
    calls["bw_gemm"] += 1
    del got
    args = (digits, b, mask, scale, bias, sx.reshape(1, -1).contiguous())
    for act in acts:
        got = bwk.bw_gemm_fused(*args, activation=act, **kw)
        want = bwk.bw_gemm_fused_plain(*args, activation=act, **kw)
        ok = torch.equal(got, want) if act is None else bool(
            torch.all((got - want).abs() <= ACT_ATOL + ACT_RTOL * want.abs()))
        if not ok:
            raise AssertionError(f"bw_gemm_fused[{act}] != plain at {what}: "
                                 f"max |diff| "
                                 f"{float((got - want).abs().max())}")
        calls["bw_gemm_fused"] += 1
        del got, want


def wide_cases(dev, log) -> dict:
    """Phase 8: B1 (with a bias, under every activation) and B2 at the
    forward's widths WIDE_NS, at the path's shapes, against their plain
    versions (``hold_b1_b2``).  Returns kernel -> calls checked."""
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(8)
    calls = {"bw_gemm_fused": 0, "bw_gemm": 0}
    for m, k, _ in PATH_SHAPES:
        w = torch.randn((k, m), generator=gen, device=dev)
        qw, sw = quant.quantize_to_planes(w, 3, axis=0)
        planned = ops.plan_operand(qw.t(), "ent", 128, 256)
        digits, mask = planned.digits, planned.mask
        scale = ops._channel_rows(sw.reshape(-1), m, digits.shape[1],
                                  planned.row_perm)
        bias = torch.randn((digits.shape[1], 1), generator=gen, device=dev)
        for n in WIDE_NS:
            x = torch.randn((n, k), generator=gen, device=dev)
            hold_b1_b2(digits, mask, scale, bias, x, ACTS, calls,
                       f"M={m} K={k} N={n} with bias", block_m=128,
                       block_k=256, radix=4)
    log(f"[forward] B1 (bias; activations {ACTS}) and B2 at N in "
        f"{WIDE_NS} on {len(PATH_SHAPES)} shapes equal their plain "
        f"versions: {json.dumps(calls)} calls")
    return calls


def plan_records(params) -> list:
    """Every ``w_plan`` record of a planned param tree, in tree order."""
    def walk(node, out):
        if isinstance(node, list):
            for v in node:
                walk(v, out)
        elif isinstance(node, dict):
            if "w_plan" in node:
                out.append(node["w_plan"])
            for key, v in node.items():
                if key != "w_plan":
                    walk(v, out)
        return out
    return walk(params, [])


def b1_bound_ms(plans, n: int) -> float:
    """The least device ms B1 could take for one call on each plan at
    N=n: the larger of the bytes it must move (the live plane blocks, the
    int8 activations, the mask, the scales and the float32 output, each
    once) at 3.35 TB/s and its int8 operations on the live digits at
    1,979 TOP/s, summed over the calls (phase 3's accounting)."""
    total_bytes = total_ops = 0
    for plan in plans:
        mask = plan["mask"]
        _, m_pad, k_pad = plan["digits"].shape
        live = int(mask.sum()) * (m_pad // mask.shape[1]) * \
            (k_pad // mask.shape[2])
        total_bytes += live + n * k_pad + mask.numel() + 4 * m_pad * n \
            + 4 * (m_pad + n)
        total_ops += 2 * live * n
    return 1e3 * max(total_bytes / HBM_BYTES_PER_S,
                     total_ops / INT8_OPS_PER_S)


def longest_launch_us(prof, symbol: str) -> tuple:
    """(the longest ``symbol`` kernel's device us, how many the profile
    holds) over a profile's kernel events."""
    times = [ns / 1e3 for name, ns in device_events(prof) if symbol in name]
    return (max(times) if times else None), len(times)


def forward_phase(cfg, params, dev, log, kind) -> dict:
    """Phase 8 (a): ``lm_apply`` on the full-width model through each
    route of FORWARD_ROUTES at each of FORWARD_SIZES (one forward
    counted: each kernel route launches its kernel 7 x layers times and
    nothing else, the oracle none; the routes' greedy tokens equal), and
    on pallas_fused ``lm_prefill`` of the first PREFILL_TOKENS tokens of
    the first size then ``lm_decode_step`` to its end, whose logits must
    be within PREFILL_LOGIT_ATOL of the forward's there, and on the mean
    within PREFILL_MEAN_ATOL, and whose greedy tokens may differ only
    where the forward's top-2 margin is within PREFILL_LOGIT_ATOL.  Logs host and device ms a forward, B1/B2's
    share and peak GB."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    rng = np.random.default_rng(8)
    tokens = {size: torch.as_tensor(rng.integers(0, cfg.vocab_size, size),
                                    device=dev) for size in FORWARD_SIZES}
    layer_calls = 7 * cfg.n_layers
    first, out, failures = {}, {}, []
    for impl, kern in FORWARD_ROUTES.items():
        rcfg = cfg.replace(quant=spec_of(impl))
        free_device_memory()
        t0 = time.perf_counter()
        planned = ops.plan_params(params, rcfg.quant)[0] if kern \
            else params
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        for size in FORWARD_SIZES:
            toks = tokens[size]
            with torch.no_grad():
                T.lm_apply(planned, toks[:, :8], rcfg, dev)      # warm-up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                zero_counts()
                t0 = time.perf_counter()
                logits, _ = T.lm_apply(planned, toks, rcfg, dev)
                torch.cuda.synchronize()
                host_ms = 1e3 * (time.perf_counter() - t0)
                launches = read_counts()
                peak_gb = torch.cuda.max_memory_allocated() / 1e9
                prof, _ = profile_calls(lambda: T.lm_apply(planned, toks,
                                                           rcfg, dev),
                                        warmed=True)
            row = {"plan_s": plan_s, "host_ms": host_ms,
                   "device_ms": prof["device_ms_per_step"],
                   "kernel_ms": prof["kernel_ms_per_step"].get(
                       SYMBOLS.get(kern, ""), 0.0),
                   "kernel_ops": prof["kernel_ops_per_step"].get(
                       SYMBOLS.get(kern, ""), 0.0),
                   "peak_gb": peak_gb, "launches": launches}
            if kern:
                row["kernel_bound_ms"] = b1_bound_ms(plan_records(planned),
                                                     size[0] * size[1])
            what = f"impl={impl} batch {size[0]} x {size[1]} tokens"
            want = {name: layer_calls if name == kern else 0
                    for name in KERNELS}
            if launches != want:
                failures.append(f"{what}: launches {launches}, expected "
                                f"{want}")
            if tuple(logits.shape) != (*size, cfg.padded_vocab) or \
                    not bool(torch.isfinite(logits).all()):
                failures.append(f"{what}: bad logits {tuple(logits.shape)}")
            if size not in first:
                first[size] = (impl, logits)
            else:
                base_impl, base = first[size]
                row["max_logit_gap"] = float(
                    (logits.float() - base.float()).abs().max())
                row["tokens_differ"] = int(
                    (logits.argmax(-1) != base.argmax(-1)).sum())
                if row["tokens_differ"]:
                    failures.append(
                        f"{what}: {row['tokens_differ']} greedy tokens "
                        f"differ from impl={base_impl}")
            if impl == "pallas_fused" and size == FORWARD_SIZES[0]:
                row["prefill_decode"] = prefill_decode(
                    planned, toks, logits, rcfg, dev, PREFILL_TOKENS)
                failures += prefill_failures(row["prefill_decode"],
                                             layer_calls, kern)
            del logits
            out[impl, size] = row
            log(f"[forward] {cfg.name} {what} (N={size[0] * size[1]}): "
                f"{json.dumps(row)}  ({kind})")
        del planned
    del first
    free_device_memory()
    if failures:
        raise AssertionError("phase 8 (a): " + "; ".join(failures))
    return out


def prefill_decode(planned, toks, logits, cfg, dev, prefill,
                   frontend=None) -> dict:
    """lm_prefill of the first ``prefill`` tokens of ``toks`` (with the
    ``frontend`` embeddings, if given), then lm_decode_step on each later
    token (teacher-forced), against the forward's ``logits``: greedy
    tokens at every position from the prefill's last one to the end
    (those that differ, with the forward's top-2 margin there), the
    largest and the mean logit gap, launches."""
    import torch
    from repro_torch.models import transformer as T

    b, t = toks.shape
    zero_counts()
    with torch.no_grad():
        step, caches = T.lm_prefill(planned, toks[:, :prefill], cfg, t, dev,
                                    frontend_embeds=frontend)
        steps = [step]
        for i in range(prefill, t):
            step, caches = T.lm_decode_step(
                planned, toks[:, i:i + 1],
                torch.full((b,), i, dtype=torch.long, device=dev), caches,
                cfg)
            steps.append(step)
        torch.cuda.synchronize()
    launches = read_counts()
    got = torch.cat(steps, dim=1).float()
    want = logits[:, prefill - 1:].float()
    differ = got.argmax(-1) != want.argmax(-1)
    top2 = want.topk(2, dim=-1).values
    margins = (top2[..., 0] - top2[..., 1])[differ]
    return {"calls": len(steps), "tokens": int(differ.numel()),
            "tokens_differ": int(differ.sum()),
            "margins": [round(float(v), 4) for v in margins],
            "max_logit_gap": float((got - want).abs().max()),
            "mean_logit_gap": float((got - want).abs().mean()),
            "launches": launches}


def prefill_failures(pd, per_call, kern) -> list:
    """What ``prefill_decode``'s result ``pd`` breaks: ``kern`` launched
    ``per_call`` times a call and no other kernel, tokens differing only
    at top-2 margins within PREFILL_LOGIT_ATOL, the largest logit gap
    within PREFILL_LOGIT_ATOL and the mean within PREFILL_MEAN_ATOL."""
    failures = []
    if pd["launches"] != {name: per_call * pd["calls"] if name == kern
                          else 0 for name in KERNELS}:
        failures.append(f"prefill + decode: launches {pd['launches']}")
    if any(v > PREFILL_LOGIT_ATOL for v in pd["margins"]) or \
            pd["max_logit_gap"] > PREFILL_LOGIT_ATOL or \
            pd["mean_logit_gap"] > PREFILL_MEAN_ATOL:
        failures.append(
            f"prefill + decode: {pd['tokens_differ']} of {pd['tokens']} "
            f"greedy tokens differ from the forward's (top-2 margins "
            f"there: {pd['margins']}), largest logit gap "
            f"{pd['max_logit_gap']} (allowed {PREFILL_LOGIT_ATOL} for "
            f"both), mean {pd['mean_logit_gap']} (allowed "
            f"{PREFILL_MEAN_ATOL})")
    return failures


def dense_config_phase(dev, log, kind) -> dict:
    """Phase 8 (b): each config of DENSE_DEPTHS at its published widths
    and the depth one card holds, params from a seeded torch.Generator,
    served by ServeEngine (batch 3, 3 seeded prompts of 8-24 tokens,
    DENSE_NEW_TOKENS new tokens) through pallas_fused and the planes
    oracle, and through pallas (B2) where the MLP folds its activation
    into the projection's epilogue.  B1 is launched once a projection and
    once for the untied head a step, nothing else; ms/step, peak GB and
    B1's longest launch in a profiled decode step (the head's) are
    logged.  Then both routes' logits teacher-forced through the served
    sequences (``lockstep_logits``): bit-identical where no activation is
    folded, and the oracle's tokens equal.  Folded (nemotron's relu2),
    the oracle rounds the projection to bfloat16 before the activation,
    as the reference's plain engines do, where B1 and B2 apply it in
    float32 (ROADMAP C7): there B1's lock-step logits must be within
    ACT_ATOL + ACT_RTOL * |B2's| of B2's (B2's epilogue is the plain
    float32 function of B1's) and its served tokens equal B2's, and the
    oracle's gap and greedy agreement are logged."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import get_api
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.request import ServeRequest

    out, failures = {}, []
    for arch, layers in DENSE_DEPTHS.items():
        cfg = get_config(arch).replace(n_layers=layers)
        folded = not cfg.gated_mlp
        free_device_memory()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(0)
        params = get_api(cfg).init(gen, cfg, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size,
                                int(rng.integers(8, 25))).tolist()
                   for _ in range(3)]
        per_step = (6 if folded else 7) * layers + \
            (0 if cfg.tie_embeddings else 1)
        runs, seqs = {}, None
        for impl in ("pallas_fused",) + (("pallas",) if folded else ()) \
                + ("planes",):
            if impl != "pallas_fused":
                free_device_memory()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            eng = ServeEngine(cfg, 3, DENSE_MAX_LEN, quant=spec_of(impl),
                              params=params, device=dev)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            reqs = [ServeRequest(i, list(p), DENSE_NEW_TOKENS)
                    for i, p in enumerate(prompts)]
            zero_counts()
            stats = eng.run(reqs)
            run = {"tokens": [r.out for r in reqs], "setup_s": setup_s,
                   "steps": stats["engine_steps"],
                   "ms_per_step": 1e3 * stats["wall_s"]
                   / stats["engine_steps"],
                   "launches": read_counts(),
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            kern = FORWARD_ROUTES[impl]
            want = {name: per_step * run["steps"] if name == kern else 0
                    for name in KERNELS}
            if run["launches"] != want:
                failures.append(f"{arch} impl={impl}: launches "
                                f"{run['launches']}, expected {want}")
            if any(len(t) != DENSE_NEW_TOKENS for t in run["tokens"]):
                failures.append(f"{arch} impl={impl}: a request did not "
                                f"generate {DENSE_NEW_TOKENS} tokens")
            if impl == "pallas_fused":
                prof, trace = profile_calls(lambda: profile_step(eng, dev))
                run["device_ms_per_step"] = prof["device_ms_per_step"]
                run["b1_ms_per_step"] = prof["kernel_ms_per_step"].get(
                    SYMBOLS["bw_gemm_fused"], 0.0)
                run["head_us"], run["b1_events"] = longest_launch_us(
                    trace, SYMBOLS["bw_gemm_fused"])
                run["head_bound_us"] = 1e3 * b1_bound_ms(
                    [eng.params["lm_head"]["w_plan"]], len(prompts))
                del trace
                seqs = [p + o for p, o in zip(prompts, run["tokens"])]
            run["lockstep"] = lockstep_logits(eng, seqs, dev)
            del eng
            runs[impl] = run
            log(f"[dense] {arch} ({layers} of {get_config(arch).n_layers} "
                f"layers) impl={impl}: "
                f"{json.dumps({k: v for k, v in run.items() if k not in ('tokens', 'lockstep')})}"
                f"  ({kind})")
        kernel, oracle = runs["pallas_fused"], runs["planes"]
        kernel_lock = kernel.pop("lockstep")
        lock = lockstep_agreement(kernel_lock, oracle.pop("lockstep"))
        lock["served_tokens_equal"] = oracle["tokens"] == kernel["tokens"]
        log(f"[dense] {arch}: the planes oracle against pallas_fused: "
            f"{json.dumps(lock)}")
        if folded:
            b2 = runs["pallas"].pop("lockstep")
            gap = (kernel_lock - b2).abs()
            lock_b2 = {"max_logit_gap": float(gap.max()), "within": bool(
                torch.all(gap <= ACT_ATOL + ACT_RTOL * b2.abs()))}
            lock_b2["served_tokens_equal"] = \
                runs["pallas"]["tokens"] == kernel["tokens"]
            log(f"[dense] {arch}: pallas (B2) against pallas_fused (B1) in "
                f"lock step: {json.dumps(lock_b2)}")
            if not (lock_b2["within"] and lock_b2["served_tokens_equal"]):
                failures.append(f"{arch}: pallas (B2) differs from "
                                f"pallas_fused (B1): {json.dumps(lock_b2)}")
            kernel["b2_lockstep"] = lock_b2
        elif lock["max_logit_gap"] != 0.0 or not lock["served_tokens_equal"]:
            failures.append(f"{arch}: the planes oracle differs from "
                            f"pallas_fused: {json.dumps(lock)}")
        out[arch] = {"layers": layers, "init_s": init_s,
                     "per_step": per_step, "oracle": lock, **runs}
        del params
    free_device_memory()
    if failures:
        raise AssertionError("phase 8 (b): " + "; ".join(failures))
    return out


def lockstep_logits(eng, seqs, dev):
    """Float32 logits [T, B, V] on the host of an engine's model
    teacher-forced through ``seqs`` (a row a sequence, cut to the
    shortest) from fresh caches."""
    import torch
    t = min(map(len, seqs))
    toks = torch.as_tensor([q[:t] for q in seqs], device=dev)
    state = eng.api.init_decode(eng.cfg, len(seqs), t, dev)
    out = []
    with torch.no_grad():
        for j in range(t):
            logits, state = eng.api.decode_step(
                eng.params, toks[:, j:j + 1],
                torch.full((len(seqs),), j, dtype=torch.long, device=dev),
                state, eng.cfg)
            out.append(logits[:, 0].float().cpu())
    return torch.stack(out)


def lockstep_agreement(kernel, oracle) -> dict:
    """Two routes' lock-step logits: the largest gap, and the positions
    whose greedy tokens differ with the oracle's top-2 margin there."""
    differ = kernel.argmax(-1) != oracle.argmax(-1)
    top2 = oracle.topk(2, dim=-1).values
    return {"positions": int(differ.numel()),
            "tokens_differ": int(differ.sum()),
            "margins": [round(float(v), 4)
                        for v in (top2[..., 0] - top2[..., 1])[differ]],
            "max_logit_gap": float((kernel - oracle).abs().max())}


# Phase 9: the MoE configs.  config -> layers run.  olmoe-1b-7b runs
# whole; grok-1-314b at its published widths, cut in depth to half of
# what one card's 80 GB holds (4 layers: a layer is 13.6 GB, 12.9 GB of
# it float32 experts, beside 3.2 GB of embedding, 6.5 GB of head and its
# plan, and a 3.2 GB bf16 copy of an expert weight during a step), for
# the script's time with phase 11.  Only the attention
# projections and the untied head are planned (B1): the router is raw and
# the experts run as bf16 einsums, as in the reference.
MOE_DEPTHS = {"olmoe-1b-7b": 16, "grok-1-314b": 2}
MOE_FORWARD_SIZE = (4, 64)           # olmoe's forward, batch x tokens
MOE_RANGE = "moe.experts"            # profiler range of the experts' FFN


def moe_counted(moe):
    """Wrap ``moe._dispatch`` so that each call adds its dropped picks and
    its picks to two device tensors (no host sync); returns (restore,
    tallies)."""
    import torch
    tallies = []
    dispatch = moe._dispatch

    def counted(xf, eidx, gate, e, k, cap, dtype):
        buf, dest, wgt = dispatch(xf, eidx, gate, e, k, cap, dtype)
        tallies.append(torch.stack([(dest == e * cap).sum(),
                                    torch.tensor(dest.numel(),
                                                 device=dest.device)]))
        return buf, dest, wgt
    moe._dispatch = counted

    def restore():
        moe._dispatch = dispatch
    return restore, tallies


def moe_experts_profile(eng, dev) -> dict:
    """torch.profiler over one decode step of a served MoE engine, with the
    experts' FFN (``moe._experts``: the bf16 weight copies, the einsums,
    the activation) inside a profiler range: the step's device ms and
    B1's, and the device ms of the kernels the range launched."""
    import torch
    from repro_torch.models import moe

    experts = moe._experts

    def ranged(*args, **kw):
        with torch.profiler.record_function(MOE_RANGE):
            return experts(*args, **kw)
    moe._experts = ranged
    try:
        prof, trace = profile_calls(lambda: profile_step(eng, dev),
                                    host=True)
    finally:
        moe._experts = experts
    experts_us = sum(e.device_time_total for e in trace.events()
                     if e.name == MOE_RANGE
                     and str(getattr(e, "device_type", "")).endswith("CPU"))
    return {"device_ms_per_step": prof["device_ms_per_step"],
            "b1_ms_per_step": prof["kernel_ms_per_step"].get(
                SYMBOLS["bw_gemm_fused"], 0.0),
            "experts_ms_per_step": experts_us / 1e3,
            "kernel_launches_per_step": prof["kernel_launches_per_step"],
            "top_kernels": prof["top_kernels"][:6]}


def moe_forward(eng, impl, toks, first, dev) -> tuple:
    """Phase 9 (a): ``lm_apply`` of ``toks`` through a served engine's
    params (B1's planned, the oracle's raw): B1 launched 4 x layers + 1
    times a forward and nothing else, the oracle nothing; the greedy
    tokens equal those of ``first`` (the logits of the first route, or
    None).  Returns (row, logits, failures)."""
    import torch
    from repro_torch.models import transformer as T

    cfg, failures = eng.cfg, []
    kern = FORWARD_ROUTES[impl]
    with torch.no_grad():
        T.lm_apply(eng.params, toks[:, :8], cfg, dev)          # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        logits, aux = T.lm_apply(eng.params, toks, cfg, dev)
        torch.cuda.synchronize()
        row = {"host_ms": 1e3 * (time.perf_counter() - t0),
               "launches": read_counts(), "aux": float(aux),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    want = {name: (4 * cfg.n_layers + 1 if name == kern else 0)
            for name in KERNELS}
    if row["launches"] != want:
        failures.append(f"forward impl={impl}: launches {row['launches']}, "
                        f"expected {want}")
    if tuple(logits.shape) != (*toks.shape, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits).all()):
        failures.append(f"forward impl={impl}: bad logits "
                        f"{tuple(logits.shape)}")
    if first is not None:
        row["max_logit_gap"] = float((logits.float()
                                      - first.float()).abs().max())
        row["tokens_differ"] = int((logits.argmax(-1)
                                    != first.argmax(-1)).sum())
        if row["tokens_differ"]:
            failures.append(f"forward impl={impl}: {row['tokens_differ']} "
                            f"greedy tokens differ from pallas_fused's")
    return row, logits, failures


def moe_config_phase(dev, log, kind) -> dict:
    """Phase 9: each config of MOE_DEPTHS at its published widths, params
    from a seeded torch.Generator, served by ServeEngine (batch 3, 3
    seeded prompts of 8-24 tokens, DENSE_NEW_TOKENS new tokens, max_len
    DENSE_MAX_LEN) through pallas_fused and the planes oracle.  B1 is
    launched 4 x layers + 1 times a step (wq, wk, wv, wo and the untied
    head) and nothing else; the oracle launches nothing.  Both routes'
    logits teacher-forced through the served sequences
    (``lockstep_logits``) must be bit-identical and the served tokens
    equal: the MoE code and the attention projections' sums are the same
    on both routes, and no activation is folded into a planned
    projection.  Logs ms/step, device and B1 ms a step, the experts'
    device ms a step, peak GB, init and plan seconds, and the share of
    the oracle's decode picks dropped by capacity; on olmoe-1b-7b also
    the forward (``moe_forward``)."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe
    from repro_torch.models.api import get_api
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.request import ServeRequest

    out, failures = {}, []
    for arch, layers in MOE_DEPTHS.items():
        cfg = get_config(arch).replace(n_layers=layers)
        free_device_memory()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(0)
        params = get_api(cfg).init(gen, cfg, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        log(f"[moe] {arch}: {cfg.param_count() / 1e9:.3f} B params "
            f"({cfg.active_param_count() / 1e9:.3f} B active) drawn in "
            f"{init_s:.2f} s  ({kind})")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size,
                                int(rng.integers(8, 25))).tolist()
                   for _ in range(3)]
        per_step = 4 * layers + (0 if cfg.tie_embeddings else 1)
        toks = torch.as_tensor(np.random.default_rng(8).integers(
            0, cfg.vocab_size, MOE_FORWARD_SIZE), device=dev)
        runs, seqs, first = {}, None, None
        for impl in ("pallas_fused", "planes"):
            free_device_memory()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            eng = ServeEngine(cfg, 3, DENSE_MAX_LEN, quant=spec_of(impl),
                              params=params, device=dev)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            reqs = [ServeRequest(i, list(p), DENSE_NEW_TOKENS)
                    for i, p in enumerate(prompts)]
            if impl == "planes":
                restore, tallies = moe_counted(moe)
            zero_counts()
            try:
                stats = eng.run(reqs)
            finally:
                if impl == "planes":
                    restore()
            run = {"tokens": [r.out for r in reqs], "setup_s": setup_s,
                   "planned_weights": (eng.plan_stats or {}).get(
                       "planned_weights", 0),
                   "steps": stats["engine_steps"],
                   "ms_per_step": 1e3 * stats["wall_s"]
                   / stats["engine_steps"],
                   "launches": read_counts(),
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            kern = FORWARD_ROUTES[impl]
            want = {name: per_step * run["steps"] if name == kern else 0
                    for name in KERNELS}
            if run["launches"] != want:
                failures.append(f"{arch} impl={impl}: launches "
                                f"{run['launches']}, expected {want}")
            if kern and run["planned_weights"] != per_step:
                failures.append(f"{arch}: {run['planned_weights']} weights "
                                f"planned, expected {per_step}")
            if any(len(t) != DENSE_NEW_TOKENS for t in run["tokens"]):
                failures.append(f"{arch} impl={impl}: a request did not "
                                f"generate {DENSE_NEW_TOKENS} tokens")
            if impl == "planes":
                dropped, picks = (int(v) for v in
                                  torch.stack(tallies).sum(0).tolist())
                run["decode_picks"] = picks
                run["decode_dropped_share"] = dropped / picks
            if impl == "pallas_fused":
                run.update(moe_experts_profile(eng, dev))
                run["experts_share"] = (run["experts_ms_per_step"]
                                        / max(run["device_ms_per_step"],
                                              1e-9))
                seqs = [p + o for p, o in zip(prompts, run["tokens"])]
            run["lockstep"] = lockstep_logits(eng, seqs, dev)
            runs[impl] = run
            log(f"[moe] {arch} ({layers} of {get_config(arch).n_layers} "
                f"layers) impl={impl}: "
                f"{json.dumps({k: v for k, v in run.items() if k not in ('tokens', 'lockstep')})}"
                f"  ({kind})")
            if arch == "olmoe-1b-7b":
                row, logits, fails = moe_forward(eng, impl, toks, first, dev)
                failures += [f"{arch} {f}" for f in fails]
                first = logits if first is None else first
                run["forward"] = row
                log(f"[moe] {arch} forward impl={impl} batch "
                    f"{MOE_FORWARD_SIZE[0]} x {MOE_FORWARD_SIZE[1]} tokens: "
                    f"{json.dumps(row)}  ({kind})")
                del logits
            del eng
        del first
        kernel, oracle = runs["pallas_fused"], runs["planes"]
        lock = lockstep_agreement(kernel.pop("lockstep"),
                                  oracle.pop("lockstep"))
        lock["served_tokens_equal"] = oracle["tokens"] == kernel["tokens"]
        log(f"[moe] {arch}: the planes oracle against pallas_fused in lock "
            f"step: {json.dumps(lock)}")
        if lock["max_logit_gap"] != 0.0 or lock["tokens_differ"] or \
                not lock["served_tokens_equal"]:
            failures.append(f"{arch}: the planes oracle differs from "
                            f"pallas_fused: {json.dumps(lock)}")
        out[arch] = {"layers": layers, "init_s": init_s,
                     "per_step": per_step, "oracle": lock, **runs}
        del params
    free_device_memory()
    if failures:
        raise AssertionError("phase 9: " + "; ".join(failures))
    return out


# Phase 10: the VLM config, phi-3-vision-4.2b on its first CONFIG_DEPTH
# layers at full width, its frontend stub fed
# seeded float32 patch embeddings.  (batch, tokens) of the multimodal
# forward: its first frontend_tokens (576) positions are the frontend's,
# so N = 2,048 with 448 text positions a row.
VLM_ARCH = "phi-3-vision-4.2b"
VLM_FORWARD_SIZE = (2, 1024)
VLM_DECODE_TOKENS = 16               # (c): decode steps after the prefill


def vlm_forward(eng, impl, toks, frontend, first, dev) -> tuple:
    """Phase 10 (b): ``lm_apply`` of ``toks`` with ``frontend`` through a
    served engine's params (B1's planned, the oracle's raw): B1 launched
    7 x layers + 1 times a forward (never for frontend_proj) and nothing
    else, the oracle nothing; finite logits of the right shape; the
    greedy tokens at the text positions equal those of ``first`` (the
    first route's logits, or None).  On B1 also the device ms and B1's
    (torch.profiler) beside ``b1_bound_ms``, and a forward with the
    frontend + 1.0, whose logits must change (the reference's
    test_vlm_frontend_changes_prefix_logits_only_causally).  Returns
    (row, logits, failures)."""
    import torch
    from repro_torch.models import transformer as T

    cfg, failures = eng.cfg, []
    f = cfg.frontend_tokens
    kern = FORWARD_ROUTES[impl]
    what = f"forward impl={impl}"

    def forward(fe=frontend):
        return T.lm_apply(eng.params, toks, cfg, dev, frontend_embeds=fe)[0]
    with torch.no_grad():
        T.lm_apply(eng.params, toks[:, :f], cfg, dev,
                   frontend_embeds=frontend)                   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        logits = forward()
        torch.cuda.synchronize()
        row = {"host_ms": 1e3 * (time.perf_counter() - t0),
               "launches": read_counts(),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if kern:
            prof, _ = profile_calls(forward, warmed=True)
            row["device_ms"] = prof["device_ms_per_step"]
            row["b1_ms"] = prof["kernel_ms_per_step"].get(SYMBOLS[kern], 0.0)
            row["b1_bound_ms"] = b1_bound_ms(plan_records(eng.params),
                                             toks.numel())
            shifted = forward(frontend + 1.0)
            row["shifted_max_logit_gap"] = float(
                (shifted.float() - logits.float()).abs().max())
            if torch.allclose(shifted.float(), logits.float()):
                failures.append(f"{what}: the frontend + 1.0 leaves the "
                                f"logits as they were")
            del shifted
    want = {name: (7 * cfg.n_layers + 1 if name == kern else 0)
            for name in KERNELS}
    if row["launches"] != want:
        failures.append(f"{what}: launches {row['launches']}, expected "
                        f"{want}")
    if tuple(logits.shape) != (*toks.shape, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits).all()):
        failures.append(f"{what}: bad logits {tuple(logits.shape)}")
    if first is not None:
        gap = (logits.float() - first.float()).abs()
        row["max_logit_gap"] = float(gap.max())
        row["text_max_logit_gap"] = float(gap[:, f:].max())
        row["text_tokens_differ"] = int(
            (logits[:, f:].argmax(-1) != first[:, f:].argmax(-1)).sum())
        if row["text_tokens_differ"]:
            failures.append(f"{what}: {row['text_tokens_differ']} greedy "
                            f"tokens at positions {f}-{toks.shape[1] - 1} "
                            f"differ from pallas_fused's")
    return row, logits, failures


def vlm_loss(eng, toks, labels, frontend, logits, dev) -> tuple:
    """Phase 10 (d): ``loss_fn`` on the multimodal batch, labels at every
    position, against the masked mean NLL of the forward's ``logits``
    over positions >= frontend_tokens (rtol 1e-6), its token count
    batch x (tokens - frontend_tokens).  Returns (row, failures)."""
    import torch
    from repro_torch.models.api import loss_fn

    cfg = eng.cfg
    f = cfg.frontend_tokens
    with torch.no_grad():
        loss, metrics = loss_fn(eng.params, {"tokens": toks, "labels": labels,
                                             "frontend": frontend}, cfg, dev)
        lf = logits[:, f:].float()
        gold = torch.take_along_dim(lf, labels[:, f:, None], dim=-1)[..., 0]
        want = float((torch.logsumexp(lf, dim=-1) - gold).mean())
    row = {"loss": float(loss), "masked_nll_of_forward": want,
           "tokens": float(metrics["tokens"]),
           "aux": float(metrics["aux_loss"])}
    failures = []
    if row["tokens"] != toks.shape[0] * (toks.shape[1] - f):
        failures.append(f"loss: {row['tokens']} tokens counted, expected "
                        f"{toks.shape[0] * (toks.shape[1] - f)}")
    if abs(row["loss"] - want) > 1e-6 * abs(want) or row["aux"] != 0.0:
        failures.append(f"loss: {json.dumps(row)}: not the forward's masked "
                        f"mean NLL within rtol 1e-6")
    return row, failures


def vlm_config_phase(dev, log, kind) -> dict:
    """Phase 10: phi-3-vision-4.2b at its published widths (d_model 3072,
    32 x 96 heads, d_ff 8192, an untied head of 32,128 rows), params
    drawn whole (32 layers) from a seeded torch.Generator and run on the
    first CONFIG_DEPTH, through pallas_fused and the planes oracle.  (a) Served by ServeEngine on text
    (batch 3, 3 seeded prompts of 8-24 tokens, DENSE_NEW_TOKENS new
    tokens): B1 launched 7 x 8 + 1 = 57 times a step and nothing else
    (frontend_proj is neither planned nor quantized), the oracle nothing;
    both routes' lock-step logits bit-identical and the served tokens
    equal (no activation is folded); ms/step, device and B1 ms a step,
    the head's B1 launch beside its bound, kernels a step, peak GB.  (b)
    The multimodal forward of VLM_FORWARD_SIZE tokens whose first 576
    positions are overwritten by seeded float32 frontend embeddings
    (``vlm_forward``).  (c) On B1, lm_prefill of one such prompt, then
    VLM_DECODE_TOKENS decode steps, against lm_apply over the whole with
    the same frontend, within phase 8 (a)'s PREFILL_LOGIT_ATOL /
    PREFILL_MEAN_ATOL.  (d) On B1, loss_fn on (b)'s batch
    (``vlm_loss``)."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.api import get_api
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.request import ServeRequest

    cfg = get_config(VLM_ARCH)
    f, (b, t) = cfg.frontend_tokens, VLM_FORWARD_SIZE
    free_device_memory()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = get_api(cfg).init(gen, cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"[vlm] {VLM_ARCH}: {cfg.param_count() / 1e9:.3f} B params (and "
        f"frontend_proj's {cfg.d_model ** 2 / 1e6:.1f} M) drawn in "
        f"{init_s:.2f} s, run on the first {CONFIG_DEPTH} of "
        f"{cfg.n_layers} layers  ({kind})")
    cfg, params = first_layers(cfg, params, CONFIG_DEPTH)
    per_step = 7 * cfg.n_layers + 1
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(8, 25)))
               .tolist() for _ in range(3)]
    rng = np.random.default_rng(10)
    toks = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (b, t + VLM_DECODE_TOKENS)), device=dev)
    frontend = torch.as_tensor(rng.standard_normal(
        (b, f, cfg.d_model)).astype(np.float32), device=dev)
    failures, runs, seqs, first = [], {}, None, None
    for impl in ("pallas_fused", "planes"):
        free_device_memory()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, 3, DENSE_MAX_LEN, quant=spec_of(impl),
                          params=params, device=dev)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        reqs = [ServeRequest(i, list(p), DENSE_NEW_TOKENS)
                for i, p in enumerate(prompts)]
        zero_counts()
        stats = eng.run(reqs)
        run = {"tokens": [r.out for r in reqs], "setup_s": setup_s,
               "planned_weights": (eng.plan_stats or {}).get(
                   "planned_weights", 0),
               "steps": stats["engine_steps"],
               "ms_per_step": 1e3 * stats["wall_s"] / stats["engine_steps"],
               "launches": read_counts(),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        kern = FORWARD_ROUTES[impl]
        want = {name: per_step * run["steps"] if name == kern else 0
                for name in KERNELS}
        if run["launches"] != want:
            failures.append(f"impl={impl}: launches {run['launches']}, "
                            f"expected {want}")
        if kern and (run["planned_weights"] != per_step
                     or "w_plan" in eng.params["frontend_proj"]):
            failures.append(f"{run['planned_weights']} weights planned, "
                            f"expected {per_step} (frontend_proj not one)")
        if any(len(q) != DENSE_NEW_TOKENS for q in run["tokens"]):
            failures.append(f"impl={impl}: a request did not generate "
                            f"{DENSE_NEW_TOKENS} tokens")
        if impl == "pallas_fused":
            prof, trace = profile_calls(lambda: profile_step(eng, dev))
            run["device_ms_per_step"] = prof["device_ms_per_step"]
            run["b1_ms_per_step"] = prof["kernel_ms_per_step"].get(
                SYMBOLS["bw_gemm_fused"], 0.0)
            run["kernels_per_step"] = prof["kernel_launches_per_step"]
            run["head_us"], run["b1_events"] = longest_launch_us(
                trace, SYMBOLS["bw_gemm_fused"])
            run["head_bound_us"] = 1e3 * b1_bound_ms(
                [eng.params["lm_head"]["w_plan"]], len(prompts))
            del trace
            seqs = [p + o for p, o in zip(prompts, run["tokens"])]
        run["lockstep"] = lockstep_logits(eng, seqs, dev)
        shown = {k: v for k, v in run.items()
                 if k not in ("tokens", "lockstep")}
        log(f"[vlm] {VLM_ARCH} impl={impl} served: {json.dumps(shown)}  "
            f"({kind})")
        run["forward"], logits, fails = vlm_forward(
            eng, impl, toks[:, :t], frontend, first, dev)
        failures += fails
        log(f"[vlm] {VLM_ARCH} forward impl={impl} batch {b} x {t} tokens "
            f"(N={b * t}, positions 0-{f - 1} the frontend's): "
            f"{json.dumps(run['forward'])}  ({kind})")
        if impl == "pallas_fused":
            first = logits
            seq, fe = toks[:1], frontend[:1]
            with torch.no_grad():
                full, _ = T.lm_apply(eng.params, seq, eng.cfg, dev,
                                     frontend_embeds=fe)
            run["prefill_decode"] = prefill_decode(
                eng.params, seq, full, eng.cfg, dev, t, frontend=fe)
            del full
            failures += prefill_failures(run["prefill_decode"], per_step,
                                         kern)
            log(f"[vlm] {VLM_ARCH} prefill of {t} tokens (the frontend's "
                f"{f} first) + {VLM_DECODE_TOKENS} decode steps against the "
                f"forward: {json.dumps(run['prefill_decode'])}  ({kind})")
            run["loss"], fails = vlm_loss(eng, toks[:, :t], toks[:, 1:t + 1],
                                          frontend, logits, dev)
            failures += fails
            log(f"[vlm] {VLM_ARCH} loss_fn, positions < {f} masked: "
                f"{json.dumps(run['loss'])}  ({kind})")
        del logits, eng
        runs[impl] = run
    del first
    kernel, oracle = runs["pallas_fused"], runs["planes"]
    lock = lockstep_agreement(kernel.pop("lockstep"), oracle.pop("lockstep"))
    lock["served_tokens_equal"] = oracle["tokens"] == kernel["tokens"]
    log(f"[vlm] {VLM_ARCH}: the planes oracle against pallas_fused in lock "
        f"step: {json.dumps(lock)}")
    if lock["max_logit_gap"] != 0.0 or lock["tokens_differ"] or \
            not lock["served_tokens_equal"]:
        failures.append(f"the planes oracle differs from pallas_fused: "
                        f"{json.dumps(lock)}")
    del params
    free_device_memory()
    if failures:
        raise AssertionError("phase 10: " + "; ".join(failures))
    return {"layers": cfg.n_layers, "init_s": init_s, "per_step": per_step,
            "oracle": lock, **runs}


# Phase 11: the RWKV config.  rwkv6-3b runs on its first CONFIG_DEPTH
# layers at full width.  The forward's batch x
# tokens (N = 1,024; cut from 2 x 1,024 for the script's time, PERF.md
# §4: the recurrence steps position by position); (c)'s prefix, run by the
# forward with its state, and the decode steps after it; (a)'s prompts,
# one more than the batch's 3 slots, so that the last reuses a slot.
RWKV_ARCH = "rwkv6-3b"
RWKV_FORWARD_SIZE = (2, 512)
RWKV_PREFIX, RWKV_DECODE_TOKENS = 256, 16
RWKV_PROMPTS = 4
# (c)'s gate: forward state + decode against the forward, largest and
# mean logit gap, on the first RWKV_GATE_DEPTH layers of the full-width
# params.  The card orders float32 sums by shape, so two forwards of 256
# and 272 tokens already differ at position 255, and the random weights
# grow that with depth: at all 32 layers the sound decode's gap (5.5625,
# mean 0.8215) is the broken ones' (5.22-6.32, 0.84-0.94) and the two
# forwards' own (4.9375, 0.8270).  At one layer, measured on this seed
# (NVIDIA H100 80GB HBM3, 700 W): sound 0.1484 / 0.0148; the handed-over
# shift rows zeroed 3.031 / 0.0963, the wkv state zeroed 3.797 / 0.4905,
# u left out 0.4385 / 0.0564 (ROADMAP C10).  The 32-layer reading, logged
# only, is no longer taken, for the script's time (PERF.md §6).
RWKV_GATE_DEPTH = 1
RWKV_LOGIT_ATOL, RWKV_MEAN_ATOL = 0.3, 0.03
RWKV_BROKEN = ("shift", "wkv", "u")


def rwkv_draw_constants(params, gen) -> None:
    """Replace, in place, the leaves rwkv_lm_init sets to constants by
    seeded draws of the same shapes, so that every parameter moves the
    logits: mu_x, mu_base, mu_k, mu_r ~ U(0, 1), u ~ U(-0.5, 1), w0 ~
    U(-6, -1), ln_x_bias ~ U(-0.5, 0.5) (tests/test_torch_rwkv.py draws
    from the same distributions)."""
    for blk in params["blocks"]:
        tm, cm = blk["tm"], blk["cm"]
        for tree, key, lo, hi in ((tm, "mu_x", 0.0, 1.0),
                                  (tm, "mu_base", 0.0, 1.0),
                                  (tm, "u", -0.5, 1.0),
                                  (tm, "w0", -6.0, -1.0),
                                  (tm, "ln_x_bias", -0.5, 0.5),
                                  (cm, "mu_k", 0.0, 1.0),
                                  (cm, "mu_r", 0.0, 1.0)):
            tree[key].uniform_(lo, hi, generator=gen)


def raw_profile(fn) -> dict:
    """torch.profiler, device activity only, over one fn() call (the
    caller has warmed it up), read from its raw kineto events: a forward
    of the RWKV family launches some 235,000 kernels, too many to record
    host ops for or to parse into the profiler's Python events in the
    script's time.  The device ms of every device event (kernels, copies,
    sets), each SYMBOLS kernel's ms, the device event count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = device_events(prof)
    return {"device_ms": sum(d for _, d in device) / 1e6,
            "kernels": len(device),
            "kernel_ms": {k: sum(d for n, d in device if k in n) / 1e6
                          for k in set(SYMBOLS.values())}}


def recurrent_forward(eng, impl, toks, first, dev, per_step, bound,
                      scan_ms) -> tuple:
    """Phases 11 (b) and 12 (b): ``api.forward`` of ``toks`` through a
    served engine's params (B1's planned, the oracle's raw): B1 launched
    ``per_step`` times and nothing else, the oracle nothing; finite logits
    of the right shape; greedy tokens equal to those of ``first`` (the
    first route's logits, or None).  On B1 also, from torch.profiler over
    one more forward (``raw_profile``), the device ms and B1's beside
    ``bound()`` (``b1_bound_ms`` of the forward's calls); and the
    recurrence's: ``scan_ms()``, one layer's scan at the forward's shapes
    profiled alone (its work does not depend on the values), times the
    layers.  Returns (row, logits, failures)."""
    import torch

    cfg, failures = eng.cfg, []
    kern = FORWARD_ROUTES[impl]
    what = f"forward impl={impl}"

    def forward():
        return eng.api.forward(eng.params, {"tokens": toks}, cfg, dev)[0]
    with torch.no_grad():
        eng.api.forward(eng.params, {"tokens": toks[:, :8]}, cfg,
                        dev)                                    # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        logits = forward()
        torch.cuda.synchronize()
        row = {"host_ms": 1e3 * (time.perf_counter() - t0),
               "launches": read_counts(),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if kern:
            t0 = time.perf_counter()
            prof = raw_profile(forward)
            row["device_ms"] = prof["device_ms"]
            row["b1_ms"] = prof["kernel_ms"][SYMBOLS[kern]]
            row["b1_bound_ms"] = bound()
            row["kernels"] = prof["kernels"]
            row["scan_ms"] = cfg.n_layers * scan_ms()
            row["other_ms"] = row["device_ms"] - row["b1_ms"] - \
                row["scan_ms"]
            row["profile_s"] = time.perf_counter() - t0
    want = {name: (per_step if name == kern else 0) for name in KERNELS}
    if row["launches"] != want:
        failures.append(f"{what}: launches {row['launches']}, expected "
                        f"{want}")
    if tuple(logits.shape) != (*toks.shape, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits).all()):
        failures.append(f"{what}: bad logits {tuple(logits.shape)}")
    if first is not None:
        row["max_logit_gap"] = float((logits.float()
                                      - first.float()).abs().max())
        row["tokens_differ"] = int((logits.argmax(-1)
                                    != first.argmax(-1)).sum())
        if row["tokens_differ"]:
            failures.append(f"{what}: {row['tokens_differ']} greedy tokens "
                            f"differ from pallas_fused's")
    return row, logits, failures


def rwkv_scan_ms(cfg, params, shape, dev) -> float:
    """One layer's ``_wkv_scan`` over seeded inputs of a forward of
    ``shape`` (batch x tokens) from a zero state: its device ms."""
    import torch
    from repro_torch.models import rwkv6 as R

    hs = cfg.rwkv_head_size
    gen = torch.Generator(device=dev).manual_seed(1)
    r, k, v, w = (torch.rand((*shape, cfg.d_model // hs, hs), generator=gen,
                             device=dev) for _ in range(4))
    s0 = torch.zeros((shape[0], cfg.d_model // hs, hs, hs), device=dev)
    u = params["blocks"][0]["tm"]["u"]
    return raw_profile(lambda: R._wkv_scan(r, k, v, w, u, s0))["device_ms"]


def rwkv_handoff(cfg, params, toks, prefix, dev, variants) -> dict:
    """Phase 11 (c): ``rwkv_lm_apply`` over ``toks``' first ``prefix``
    tokens with ``return_state``, then ``rwkv_lm_decode_step`` on each
    later token (teacher-forced) from that state, against
    ``rwkv_lm_apply`` over all of ``toks``, once a variant: None is the
    sound decode; "shift" zeroes the handed-over shift rows, "wkv" the
    handed-over wkv state, "u" leaves the bonus out of the decode steps
    (what the gate must catch).  Per variant: tokens differing, their top-2 margins, the
    largest and the mean logit gap and, at the prefix's last position
    (two forwards, of ``prefix`` tokens and of all), the largest gap;
    the launches of the prefix's forward and the decode steps."""
    import torch
    from repro_torch.models import rwkv6 as R

    t = toks.shape[1]
    with torch.no_grad():
        want = R.rwkv_lm_apply(params, toks, cfg, device=dev)[0][
            :, prefix - 1:].float()
    out = {}
    for broken in variants:
        p = params
        if broken == "u":
            p = dict(params, blocks=[
                dict(blk, tm=dict(blk["tm"], u=torch.zeros_like(
                    blk["tm"]["u"]))) for blk in params["blocks"]])
        zero_counts()
        with torch.no_grad():
            step, state = R.rwkv_lm_apply(params, toks[:, :prefix], cfg,
                                          return_state=True, device=dev)
            steps = [step[:, -1:]]
            if broken in ("shift", "wkv"):
                keys = ("shift_tm", "shift_cm") if broken == "shift" \
                    else ("wkv",)
                state = {k: (torch.zeros_like(v) if k in keys else v)
                         for k, v in state.items()}
            for i in range(prefix, t):
                step, state = R.rwkv_lm_decode_step(p, toks[:, i:i + 1],
                                                    None, state, cfg)
                steps.append(step)
            torch.cuda.synchronize()
        got = torch.cat(steps, dim=1).float()
        out[broken] = decode_reading(got, want, 1 + t - prefix)
        out[broken]["forwards_max_gap"] = float(
            (got[:, 0] - want[:, 0]).abs().max())
    return out


def decode_reading(got, want, calls) -> dict:
    """A decode's logits ``got`` against the forward's ``want`` (float32
    [B, T, V]): ``lockstep_agreement``'s flips, margins and largest gap,
    the mean gap, and the kernels launched since the counts were
    zeroed."""
    row = lockstep_agreement(got, want)
    row.update(calls=calls, tokens=row.pop("positions"),
               mean_logit_gap=float((got - want).abs().mean()),
               launches=read_counts())
    return row


def decode_gate_failures(sound, broken, atol, mean_atol, what) -> list:
    """Phases 11 (c), 12 (d) and 13 (c): the sound decode (a
    ``decode_reading``) within ``atol`` (largest gap, and the top-2
    margin of any token flipped) and ``mean_atol`` (mean); each broken
    decode outside it."""
    failures = []
    if any(v > atol for v in sound["margins"]) or \
            sound["max_logit_gap"] > atol or \
            sound["mean_logit_gap"] > mean_atol:
        failures.append(
            f"{what}: {sound['tokens_differ']} of {sound['tokens']} greedy "
            f"tokens differ from the forward's (top-2 margins there: "
            f"{sound['margins']}), largest logit gap "
            f"{sound['max_logit_gap']} (allowed {atol}), mean "
            f"{sound['mean_logit_gap']} (allowed {mean_atol})")
    for name, row in broken.items():
        if row["max_logit_gap"] <= atol and \
                row["mean_logit_gap"] <= mean_atol:
            failures.append(f"the decode broken by {name!r} passes the "
                            f"gate: largest {row['max_logit_gap']}, mean "
                            f"{row['mean_logit_gap']}")
    return failures


def rwkv_loss(eng, toks, labels, logits, dev, frontend=None) -> tuple:
    """Phase 11 (d), phase 12 (e), phase 13 (d): ``loss_fn`` on (b)'s
    batch (with its ``frontend`` frames, if any), labels at every
    position, against the mean NLL of the forward's ``logits`` (rtol
    1e-6), every position counted.  Returns (row, failures)."""
    import torch
    from repro_torch.models.api import loss_fn

    batch = {"tokens": toks, "labels": labels}
    if frontend is not None:
        batch["frontend"] = frontend
    with torch.no_grad():
        loss, metrics = loss_fn(eng.params, batch, eng.cfg, dev)
        lf = logits.float()
        gold = torch.take_along_dim(lf, labels[..., None], dim=-1)[..., 0]
        want = float((torch.logsumexp(lf, dim=-1) - gold).mean())
    row = {"loss": float(loss), "nll_of_forward": want,
           "tokens": float(metrics["tokens"]),
           "aux": float(metrics["aux_loss"])}
    failures = []
    if row["tokens"] != toks.numel():
        failures.append(f"loss: {row['tokens']} tokens counted, expected "
                        f"{toks.numel()}")
    if abs(row["loss"] - want) > 1e-6 * abs(want) or row["aux"] != 0.0:
        failures.append(f"loss: {json.dumps(row)}: not the forward's mean "
                        f"NLL within rtol 1e-6")
    return row, failures


def serve_route(cfg, params, impl, prompts, seqs, dev, per_step,
                head, planned=None) -> tuple:
    """Phases 11-13 (a): ServeEngine (batch 3, DENSE_MAX_LEN) on
    ``params`` through ``impl``, ``prompts`` (more than 3: a slot is
    reused) with DENSE_NEW_TOKENS new tokens each: on a kernel route
    ``planned`` weights planned (None: ``per_step``), none of them under
    ``ops._NO_PLAN_KEYS``, and the route's kernel (FORWARD_ROUTES)
    launched ``per_step`` times a step and nothing else; the oracle
    nothing; every request its tokens.  On B1 also, from torch.profiler
    over one more decode step, device and B1 ms a step, kernels a step
    and the ``head`` weight's launch beside its bound.  ``run["lockstep"]``
    holds the logits teacher-forced through ``seqs`` (None: the served
    sequences).  Returns (engine, run, failures)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.request import ServeRequest

    kern, failures = FORWARD_ROUTES[impl], []
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, 3, DENSE_MAX_LEN, quant=spec_of(impl),
                      params=params, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reqs = [ServeRequest(i, list(q), DENSE_NEW_TOKENS)
            for i, q in enumerate(prompts)]
    zero_counts()
    stats = eng.run(reqs)
    run = {"tokens": [r.out for r in reqs], "setup_s": setup_s,
           "planned_weights": (eng.plan_stats or {}).get(
               "planned_weights", 0),
           "steps": stats["engine_steps"],
           "ms_per_step": 1e3 * stats["wall_s"] / stats["engine_steps"],
           "launches": read_counts(),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    want = {name: per_step * run["steps"] if name == kern else 0
            for name in KERNELS}
    if run["launches"] != want:
        failures.append(f"impl={impl}: launches {run['launches']}, "
                        f"expected {want}")
    raw = [key for key in ops._NO_PLAN_KEYS
           if any("w_plan" in w for w in planned_under(eng.params, key))]
    planned = per_step if planned is None else planned
    if kern and (run["planned_weights"] != planned or raw):
        failures.append(f"{run['planned_weights']} weights planned, "
                        f"expected {planned}; planned, but raw in the "
                        f"reference: {raw}")
    if any(len(q) != DENSE_NEW_TOKENS for q in run["tokens"]):
        failures.append(f"impl={impl}: a request did not generate "
                        f"{DENSE_NEW_TOKENS} tokens")
    if impl == "pallas_fused":
        prof, trace = profile_calls(lambda: profile_step(eng, dev))
        run["device_ms_per_step"] = prof["device_ms_per_step"]
        run["b1_ms_per_step"] = prof["kernel_ms_per_step"].get(
            SYMBOLS[kern], 0.0)
        run["kernels_per_step"] = prof["kernel_launches_per_step"]
        run["head_us"], run["b1_events"] = longest_launch_us(
            trace, SYMBOLS[kern])
        run["head_bound_us"] = 1e3 * b1_bound_ms(
            [eng.params[head]["w_plan"]], eng.batch)
        del trace
    run["lockstep"] = lockstep_logits(
        eng, seqs or [q + o for q, o in zip(prompts, run["tokens"])], dev)
    return eng, run, failures


def planned_under(params, key) -> list:
    """Every dict of a param tree held under ``key``."""
    out = []

    def walk(node):
        if isinstance(node, list):
            for v in node:
                walk(v)
        elif isinstance(node, dict):
            for k, v in node.items():
                if k == key and isinstance(v, dict):
                    out.append(v)
                walk(v)
    walk(params)
    return out


def fresh_slot_check(cfg, params, impl, prompts, run, dev, per_step,
                     log, tag) -> list:
    """Phases 11 (a) and 12 (a): the last of ``prompts``, served in a
    reused slot in ``run``, alone on a fresh engine: the same tokens, B1
    launched ``per_step`` times a step.  Sets ``run["fresh"]``; returns
    the failures."""
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.request import ServeRequest

    kern = FORWARD_ROUTES[impl]
    free_device_memory()
    last = len(prompts) - 1
    fresh = ServeEngine(cfg, 3, DENSE_MAX_LEN, quant=spec_of(impl),
                        params=params, device=dev)
    alone = ServeRequest(last, list(prompts[last]), DENSE_NEW_TOKENS)
    zero_counts()
    stats = fresh.run([alone])
    run["fresh"] = {"tokens": alone.out, "steps": stats["engine_steps"],
                    "launches": read_counts()}
    failures = []
    if run["fresh"]["launches"] != {
            name: per_step * run["fresh"]["steps"] if name == kern else 0
            for name in KERNELS}:
        failures.append(f"fresh engine: launches {run['fresh']['launches']}")
    if alone.out != run["tokens"][last]:
        failures.append(f"request {last} in a reused slot emitted "
                        f"{run['tokens'][last]}, alone on a fresh engine "
                        f"{alone.out}")
    log(f"{tag} impl={impl}: request {last} in a reused slot "
        f"{run['tokens'][last]}, alone on a fresh engine {alone.out}")
    return failures


def oracle_agreement(runs, log, tag) -> tuple:
    """Phases 11 and 12: the planes oracle against pallas_fused, their
    lock-step logits (popped from ``runs``) bit-identical and their
    served tokens equal.  Returns (the agreement, failures)."""
    kernel, oracle = runs["pallas_fused"], runs["planes"]
    lock = lockstep_agreement(kernel.pop("lockstep"), oracle.pop("lockstep"))
    lock["served_tokens_equal"] = oracle["tokens"] == kernel["tokens"]
    log(f"{tag}: the planes oracle against pallas_fused in lock step: "
        f"{json.dumps(lock)}")
    if lock["max_logit_gap"] != 0.0 or lock["tokens_differ"] or \
            not lock["served_tokens_equal"]:
        return lock, [f"the planes oracle differs from pallas_fused: "
                      f"{json.dumps(lock)}"]
    return lock, []


def rwkv_config_phase(dev, log, kind) -> dict:
    """Phase 11: rwkv6-3b at its published widths (d_model 2560, 40 heads
    x 64, d_ff 8960, an untied head of 65,536 rows), params drawn whole
    (32 layers) from a seeded torch.Generator with the constant leaves
    drawn (``rwkv_draw_constants``) and run on the first CONFIG_DEPTH,
    through pallas_fused and the planes oracle.  Eight weights a layer and the head are planned; the mixing
    LoRAs are float32 matmuls and mix_w2 an einsum, never planned: B1
    launched 8 x 8 + 1 = 65 times a decode step or forward and nothing
    else, the oracle nothing.  (a) Served by ServeEngine (batch 3,
    RWKV_PROMPTS seeded prompts of 8-24 tokens, DENSE_NEW_TOKENS new
    tokens; the last request reuses a slot, whose recurrent row is
    reset): both routes' lock-step logits bit-identical and the served
    tokens equal; on B1 the request in the reused slot emits the tokens
    it emits alone on a fresh engine; ms/step, device and B1 ms a step,
    the head's B1 launch beside its bound, kernels a step, peak GB.  (b)
    The forward of RWKV_FORWARD_SIZE seeded tokens
    (``recurrent_forward``).
    (c) On B1, the forward over RWKV_PREFIX tokens with its state, then
    RWKV_DECODE_TOKENS decode steps, against the forward over the whole
    (``rwkv_handoff``): gated at RWKV_GATE_DEPTH (within RWKV_LOGIT_ATOL
    / RWKV_MEAN_ATOL, the three broken decodes outside them).  (d) On B1, loss_fn on (b)'s batch (``rwkv_loss``)."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import get_api
    from repro_torch.serving.engine import state_leaves

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("phase 11: TF32 is on for float32 matmuls; the "
                             "RWKV LoRAs and scan must run in float32")
    cfg = get_config(RWKV_ARCH)
    (b, t), p = RWKV_FORWARD_SIZE, RWKV_PREFIX
    free_device_memory()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = get_api(cfg).init(gen, cfg, dev)
    rwkv_draw_constants(params, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in state_leaves(params))
    log(f"[rwkv] {RWKV_ARCH}: {n_params / 1e9:.3f} B params "
        f"(param_count {cfg.param_count() / 1e9:.3f} B) drawn in "
        f"{init_s:.2f} s, run on the first {CONFIG_DEPTH} of "
        f"{cfg.n_layers} layers  ({kind})")
    cfg, params = first_layers(cfg, params, CONFIG_DEPTH)
    per_step = 8 * cfg.n_layers + 1
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(8, 25)))
               .tolist() for _ in range(RWKV_PROMPTS)]
    rng = np.random.default_rng(11)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, t + 1)),
                           device=dev)
    failures, runs, seqs, first = [], {}, None, None
    for impl in ("pallas_fused", "planes"):
        kern = FORWARD_ROUTES[impl]
        eng, run, fails = serve_route(cfg, params, impl, prompts, seqs, dev,
                                      per_step, "head")
        failures += fails
        if kern:
            seqs = [q + o for q, o in zip(prompts, run["tokens"])]
        shown = {k: v for k, v in run.items()
                 if k not in ("tokens", "lockstep")}
        log(f"[rwkv] {RWKV_ARCH} impl={impl} served: {json.dumps(shown)}  "
            f"({kind})")
        run["forward"], logits, fails = recurrent_forward(
            eng, impl, toks[:, :t], first, dev, per_step,
            lambda: b1_bound_ms(plan_records(eng.params), b * t),
            lambda: rwkv_scan_ms(cfg, params, (b, t), dev))
        failures += fails
        log(f"[rwkv] {RWKV_ARCH} forward impl={impl} batch {b} x {t} tokens "
            f"(N={b * t}): {json.dumps(run['forward'])}  ({kind})")
        if impl == "pallas_fused":
            first = logits
            seq = toks[:, :p + RWKV_DECODE_TOKENS]
            depth = RWKV_GATE_DEPTH
            gated = rwkv_handoff(
                eng.cfg.replace(n_layers=depth),
                dict(eng.params, blocks=eng.params["blocks"][:depth]), seq,
                p, dev, (None,) + RWKV_BROKEN)
            for row in gated.values():
                n = 8 * depth + 1
                if row["launches"] != {name: n * row["calls"] if name == kern
                                       else 0 for name in KERNELS}:
                    failures.append(f"forward state + decode: launches "
                                    f"{row['launches']}, expected {n} a "
                                    f"call")
            failures += decode_gate_failures(
                gated[None], {k: gated[k] for k in RWKV_BROKEN},
                RWKV_LOGIT_ATOL, RWKV_MEAN_ATOL, "forward state + decode")
            run["state_decode"] = {
                f"{depth}_layer": {str(k): {key: r[key] for key in (
                    "tokens_differ", "max_logit_gap", "mean_logit_gap",
                    "forwards_max_gap")} for k, r in gated.items()}}
            log(f"[rwkv] {RWKV_ARCH} forward of {p} tokens with its state + "
                f"{RWKV_DECODE_TOKENS} decode steps against the forward "
                f"(gated at {depth} layer(s): largest {RWKV_LOGIT_ATOL}, "
                f"mean {RWKV_MEAN_ATOL}): "
                f"{json.dumps(run['state_decode'])}  ({kind})")
            run["loss"], fails = rwkv_loss(eng, toks[:, :t], toks[:, 1:t + 1],
                                           logits, dev)
            failures += fails
            log(f"[rwkv] {RWKV_ARCH} loss_fn, labels at every position: "
                f"{json.dumps(run['loss'])}  ({kind})")
        del logits, eng
        if kern:
            failures += fresh_slot_check(cfg, params, impl, prompts, run,
                                         dev, per_step, log,
                                         f"[rwkv] {RWKV_ARCH}")
        runs[impl] = run
    del first
    lock, fails = oracle_agreement(runs, log, f"[rwkv] {RWKV_ARCH}")
    failures += fails
    del params
    free_device_memory()
    if failures:
        raise AssertionError("phase 11: " + "; ".join(failures))
    return {"layers": cfg.n_layers, "init_s": init_s, "per_step": per_step,
            "oracle": lock, **runs}


# Phase 12: the hybrid config.  hymba-1.5b runs on its first
# CONFIG_DEPTH layers at full width.  (b)'s batch x
# tokens: 384 + the 128 meta tokens = 512 positions a row (N = 1,024 in
# each layer, 768 at the head; cut from 896 + 128 for the script's time,
# PERF.md §4: the scan steps position by position); (a)'s prompts, one
# more than the batch's 3 slots, so that the last reuses a slot; (c)'s q /
# k / v [B, T, H, D], the shapes a forward of 3,968 tokens with meta
# reaches, and its tolerance: in bf16 the plain walk rounds the normalised
# probabilities and the chunked one the unnormalised weights, so the two
# sit a bf16 ulp apart (2^-7 of the largest value bounds one ulp of any
# value; tests/test_torch_hymba.py's WALKS_TOL); (d)'s tokens a row.
HYMBA_ARCH = "hymba-1.5b"
HYMBA_FORWARD_SIZE = (2, 384)
HYMBA_PROMPTS = 4
HYMBA_WINDOW_SHAPE = (1, 4096, 25, 64)
HYMBA_WINDOW_RTOL = 2.0 ** -7
HYMBA_DECODE_TOKENS = 32
# (d)'s gate: the forward without meta against token-by-token decode on
# the first HYMBA_GATE_DEPTH layers, largest and mean logit gap.  The
# decode does not give the forward's bits: gate_draws.py found the first
# place they part at layer 0's dt_proj, a float32 matmul whose inputs
# matched bit for bit and whose outputs at 2 positions and at 64 sit an
# ulp apart (another sum order), and the random weights grow that with
# depth.  At 32 layers, over six draws of tokens (phase 12's among them),
# the sound decode (2.45-4.29 / 0.246-0.335) nears the broken ones
# (5.72-7.13 / 0.84-0.96); at 4 layers they part on every draw: sound
# 0.157-0.256 / 0.0107-0.0143, the SSM state zeroed 5.89-6.63 /
# 0.597-0.718, the conv state zeroed 6.11-6.94 / 0.938-0.958, the KV ring
# not carried 4.14-5.93 / 0.331-0.435 (NVIDIA H100 80GB HBM3, 700 W;
# ROADMAP C11).  Four layers also catch a state handed to the wrong layer,
# which one layer would not.  The gate sits about halfway (geometrically)
# between the largest sound reading and the smallest broken one on each.
HYMBA_GATE_DEPTH = 4
HYMBA_LOGIT_ATOL, HYMBA_MEAN_ATOL = 1.0, 0.07
HYMBA_BROKEN = ("h", "conv", "ring")


def hymba_draw_constants(params, gen) -> None:
    """Replace, in place, the leaves hymba_lm_init sets to ones (the
    fusion's beta_attn and beta_ssm, the SSM's d_skip) by seeded
    U(0.5, 1.5) draws, so that a swapped beta or a dropped skip moves the
    logits (tests/test_torch_hymba.py draws from the same distribution)."""
    for blk in params["blocks"]:
        for tree, key in ((blk, "beta_attn"), (blk, "beta_ssm"),
                          (blk["ssm"], "d_skip")):
            tree[key].uniform_(0.5, 1.5, generator=gen)


def hymba_scan_ms(cfg, params, shape, dev) -> float:
    """One layer's ``_selective_scan`` over seeded inputs of a forward of
    ``shape`` (batch x positions, the meta tokens included) from a zero
    state: its device ms."""
    import torch
    from repro_torch.models import ssm as S

    (b, tt), di, n = shape, cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    gen = torch.Generator(device=dev).manual_seed(1)
    xs, dt = (torch.rand((b, tt, di), generator=gen, device=dev)
              for _ in range(2))
    bmat, cmat = (torch.rand((b, tt, n), generator=gen, device=dev)
                  for _ in range(2))
    h0 = torch.zeros((b, di, n), device=dev)
    a = -torch.exp(params["blocks"][0]["ssm"]["a_log"])
    return raw_profile(lambda: S._selective_scan(
        xs, dt, bmat, cmat, a, h0))["device_ms"]


def hymba_bound_ms(params, b, t) -> float:
    """``b1_bound_ms`` of a forward of b x t tokens: every layer's calls
    at N = b x (t + 128), the meta tokens included; the head's at b x t."""
    from repro_torch.models import hymba as H

    head = params["lm_head"]["w_plan"]
    return b1_bound_ms([p for p in plan_records(params) if p is not head],
                       b * (t + H.N_META)) + b1_bound_ms([head], b * t)


def hymba_windows(dev) -> dict:
    """Phase 12 (c): ``_windowed_chunked`` (W 2,048, chunk 2,048) against
    ``_windowed`` on seeded bf16 q / k / v of HYMBA_WINDOW_SHAPE, within
    HYMBA_WINDOW_RTOL of the plain walk's largest value; the gaps and
    each walk's ms (host clock, synchronised)."""
    import torch
    from repro_torch.models import hymba as H

    b, t, h, d = HYMBA_WINDOW_SHAPE
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn((b, t, h, d), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    pos = torch.arange(t, device=dev)[None].expand(b, t)
    out = {}
    with torch.no_grad():
        for name, fn in (("plain", lambda: H._windowed(
                q, k, v, H.HYMBA_WINDOW, pos)),
                         ("chunked", lambda: H._windowed_chunked(
                             q, k, v, H.HYMBA_WINDOW, H.HYMBA_WINDOW))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[name] = fn().float()
            torch.cuda.synchronize()
            out[f"{name}_ms"] = 1e3 * (time.perf_counter() - t0)
    gap = (out.pop("chunked") - out["plain"]).abs()
    largest = float(out.pop("plain").abs().max())
    row = {**out, "largest": largest, "max_gap": float(gap.max()),
           "mean_gap": float(gap.mean()),
           "atol": HYMBA_WINDOW_RTOL * largest}
    del q, k, v, gap
    return row


def hymba_handoff(cfg, params, toks, dev, variants) -> dict:
    """Phase 12 (d): ``hymba_lm_apply(with_meta=False)`` over ``toks``
    against ``hymba_lm_decode_step`` on each token (teacher-forced) from
    ``init_hymba_caches``, once a variant: None is the sound decode; "h"
    zeroes the SSM state and "conv" the conv state before each step,
    "ring" starts each step from an empty KV ring (a token attends only
    to itself).  Per variant: tokens differing, their top-2 margins, the
    largest and the mean logit gap, the launches of the decode steps; and
    the gap over the first half of the positions between the forwards of
    the first half and of all (the card's own sum orders by shape)."""
    import torch
    from repro_torch.models import hymba as H

    b, t = toks.shape
    with torch.no_grad():
        want = H.hymba_lm_apply(params, toks, cfg, dev,
                                with_meta=False)[0].float()
        half = H.hymba_lm_apply(params, toks[:, :t // 2], cfg, dev,
                                with_meta=False)[0].float()
    forwards = float((half - want[:, :t // 2]).abs().max())
    out = {}
    for broken in variants:
        zero_counts()
        with torch.no_grad():
            state = H.init_hymba_caches(cfg, b, device=dev)
            steps = []
            for i in range(t):
                if broken in ("h", "conv"):
                    state["ssm"][broken].zero_()
                elif broken == "ring":
                    state["kv"]["k"].zero_()
                    state["kv"]["v"].zero_()
                    state["kv"]["pos"].fill_(-1)
                step, state = H.hymba_lm_decode_step(
                    params, toks[:, i:i + 1],
                    torch.full((b,), i, dtype=torch.int32, device=dev),
                    state, cfg)
                steps.append(step)
            torch.cuda.synchronize()
        got = torch.cat(steps, dim=1).float()
        out[broken] = dict(decode_reading(got, want, t),
                           forwards_max_gap=forwards)
        del state, steps, got
    return out


def hybrid_config_phase(dev, log, kind) -> dict:
    """Phase 12: hymba-1.5b at its published widths (d_model 1600, 25
    heads x 64 with 5 kv heads, d_ff 5504, ssm_state 16, an untied head
    of 32,128 rows), params drawn whole (32 layers) from a seeded
    torch.Generator with the betas and d_skip drawn
    (``hymba_draw_constants``) and run on the first CONFIG_DEPTH, through
    pallas_fused and the planes oracle, TF32 off.  Nine weights a layer
    (wq, wk, wv, wo, in_proj, out_proj, gate, up, down) and the head are
    planned; x_to_dt, dt_proj and x_to_bc are float32 matmuls, never
    planned: B1 launched 9 x 8 + 1 = 73 times a decode step or forward
    and nothing else, the oracle nothing.  (a) Served by ServeEngine
    (batch 3, HYMBA_PROMPTS seeded prompts of 8-24 tokens,
    DENSE_NEW_TOKENS new tokens, max_len 32; the last request reuses a
    slot, whose ring and SSM rows are reset): both routes' lock-step
    logits bit-identical and the served tokens equal; on B1 the request
    in the reused slot emits the tokens it emits alone on a fresh engine;
    ms/step, device and B1 ms a step, the head's B1 launch beside its
    bound, kernels a step, peak GB.  (b) The forward of
    HYMBA_FORWARD_SIZE seeded tokens after the meta tokens
    (``recurrent_forward``).  (c) ``_windowed_chunked`` against
    ``_windowed`` at HYMBA_WINDOW_SHAPE (``hymba_windows``).  (d) On B1,
    the forward without meta over HYMBA_DECODE_TOKENS tokens against
    token-by-token decode (``hymba_handoff``) on the first
    HYMBA_GATE_DEPTH layers: the sound decode within HYMBA_LOGIT_ATOL /
    HYMBA_MEAN_ATOL, the three broken decodes outside them.  (e) On B1,
    loss_fn on (b)'s batch (``rwkv_loss``)."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import hymba as H
    from repro_torch.models.api import get_api
    from repro_torch.serving.engine import state_leaves

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("phase 12: TF32 is on for float32 matmuls; the "
                             "SSM's projections and scan must run in "
                             "float32")
    cfg = get_config(HYMBA_ARCH)
    b, t = HYMBA_FORWARD_SIZE
    free_device_memory()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = get_api(cfg).init(gen, cfg, dev)
    hymba_draw_constants(params, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in state_leaves(params))
    log(f"[hybrid] {HYMBA_ARCH}: {n_params / 1e9:.3f} B params "
        f"(param_count {cfg.param_count() / 1e9:.3f} B) drawn in "
        f"{init_s:.2f} s, run on the first {CONFIG_DEPTH} of "
        f"{cfg.n_layers} layers  ({kind})")
    cfg, params = first_layers(cfg, params, CONFIG_DEPTH)
    per_step = 9 * cfg.n_layers + 1
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(8, 25)))
               .tolist() for _ in range(HYMBA_PROMPTS)]
    rng = np.random.default_rng(11)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, t + 1)),
                           device=dev)
    failures, runs, seqs, first = [], {}, None, None
    tag = f"[hybrid] {HYMBA_ARCH}"
    for impl in ("pallas_fused", "planes"):
        kern = FORWARD_ROUTES[impl]
        eng, run, fails = serve_route(cfg, params, impl, prompts, seqs, dev,
                                      per_step, "lm_head")
        failures += fails
        if kern:
            seqs = [q + o for q, o in zip(prompts, run["tokens"])]
        shown = {k: v for k, v in run.items()
                 if k not in ("tokens", "lockstep")}
        log(f"{tag} impl={impl} served: {json.dumps(shown)}  ({kind})")
        run["forward"], logits, fails = recurrent_forward(
            eng, impl, toks[:, :t], first, dev, per_step,
            lambda: hymba_bound_ms(eng.params, b, t),
            lambda: hymba_scan_ms(cfg, params, (b, t + H.N_META), dev))
        failures += fails
        log(f"{tag} forward impl={impl} batch {b} x {t} tokens after "
            f"{H.N_META} meta tokens: {json.dumps(run['forward'])}  ({kind})")
        if kern:
            first = logits
            run["windows"] = hymba_windows(dev)
            if run["windows"]["max_gap"] > run["windows"]["atol"]:
                failures.append(f"_windowed_chunked against _windowed: "
                                f"{json.dumps(run['windows'])}")
            log(f"{tag} _windowed_chunked against _windowed at "
                f"{list(HYMBA_WINDOW_SHAPE)} bf16, W = chunk = "
                f"{H.HYMBA_WINDOW}: {json.dumps(run['windows'])}  ({kind})")
            depth = min(HYMBA_GATE_DEPTH, cfg.n_layers)
            rows = hymba_handoff(
                eng.cfg.replace(n_layers=depth),
                dict(eng.params, blocks=eng.params["blocks"][:depth]),
                toks[:, :HYMBA_DECODE_TOKENS], dev, (None,) + HYMBA_BROKEN)
            for row in rows.values():
                if row["launches"] != {name: (9 * depth + 1) * row["calls"]
                                       if name == kern else 0
                                       for name in KERNELS}:
                    failures.append(f"forward without meta against decode: "
                                    f"launches {row['launches']}, expected "
                                    f"{9 * depth + 1} a call")
            failures += decode_gate_failures(
                rows[None], {k: rows[k] for k in HYMBA_BROKEN},
                HYMBA_LOGIT_ATOL, HYMBA_MEAN_ATOL,
                "forward without meta against decode")
            run["decode"] = {str(k): {key: r[key] for key in (
                "tokens_differ", "margins", "max_logit_gap",
                "mean_logit_gap", "forwards_max_gap")}
                for k, r in rows.items()}
            log(f"{tag} forward without meta over {HYMBA_DECODE_TOKENS} "
                f"tokens against as many decode steps on {depth} layer(s) "
                f"(gate: largest {HYMBA_LOGIT_ATOL}, mean "
                f"{HYMBA_MEAN_ATOL}): {json.dumps(run['decode'])}  ({kind})")
            run["loss"], fails = rwkv_loss(eng, toks[:, :t], toks[:, 1:t + 1],
                                           logits, dev)
            failures += fails
            log(f"{tag} loss_fn, labels at every position: "
                f"{json.dumps(run['loss'])}  ({kind})")
        del logits, eng
        if kern:
            failures += fresh_slot_check(cfg, params, impl, prompts, run,
                                         dev, per_step, log, tag)
        runs[impl] = run
    del first
    lock, fails = oracle_agreement(runs, log, tag)
    failures += fails
    del params
    free_device_memory()
    if failures:
        raise AssertionError("phase 12: " + "; ".join(failures))
    return {"layers": cfg.n_layers, "init_s": init_s, "per_step": per_step,
            "oracle": lock, **runs}


# Phase 13: the encoder-decoder config.  seamless-m4t-medium runs whole.
# (a)'s prompts, one more than the batch's 3 slots, so that the last
# reuses a slot; (b)'s batch x decoder tokens, over the config's 512
# frames a row (N = 1,024 in the encoder and the cross wk / wv, 128 in
# the decoder's other projections and the head).  (a) and (b)'s B1-to-B2
# gate, on the lock-step and the forward's logits: B1 applies the gelu
# (tanh form) in its epilogue with the card's tanhf, B2's route with
# torch's float32 ops on the same float32 products, which could part the
# two by an ulp of an activation for 12 layers of per-token quantization
# to grow; a greedy token may differ only where the top-2 margin is
# within the gate.  Measured on this seed (NVIDIA H100 80GB HBM3, 700 W):
# bit for bit, served and forward, so the gate is 0 (ROADMAP C12).
ENCDEC_ARCH = "seamless-m4t-medium"
ENCDEC_PROMPTS = 4
ENCDEC_FORWARD_SIZE = (2, 64)
ENCDEC_ACT_GAP = 0.0
# (c): prime + teacher-forced decode against (b)'s forward on all 12
# decoder layers, largest and mean logit gap; three broken decodes must
# read outside the gate: the cross K/V left zero (what serving decodes
# against), the two requests' cross K/V rows swapped, the self cache one
# position off (each token written and read at its position + 1, beside an
# unwritten zero slot).  Measured (NVIDIA H100 80GB HBM3, 700 W), largest /
# mean: in this script, sound 0.260 / 0.0133 (11 of 128 tokens flipped, at
# top-2 margins up to 0.0625); over five draws of tokens and frames, this
# phase's among them, in a process of their own (gate_draws.py), sound
# 0.047-0.051 / 0.0063-0.0064, zeroed 5.11-5.98 / 0.761-0.822, swapped
# 1.00-1.25 / 0.161-0.189, shifted 2.09-2.29 / 0.083-0.090.  Where a sound
# decode first parts from the forward, every earlier projection matched
# bit for bit and one element of a bf16 activation sits one ulp off (the
# self attention's output on one draw, the first norm's on another): a
# float32 sum taken in another order at 1 position than at 64, then grown
# by quantization steps (ROADMAP C12).  The gate sits about halfway
# (geometrically) between the largest sound reading and the smallest
# broken one on each: 0.5 (swapped 2.0x above it, sound 1.9x below) and
# 0.035 (shifted 2.4x above, sound 2.6x below).
ENCDEC_LOGIT_ATOL, ENCDEC_MEAN_ATOL = 0.5, 0.035
ENCDEC_BROKEN = ("zero_cross", "swapped_cross", "shifted_cache")


def encdec_per_n(params) -> tuple:
    """The planned records of an encdec tree split by the N a forward of
    b x t tokens over b x f frames gives them: (those at N = b x f -- the
    encoder's and the decoder's cross wk / wv, what priming runs --,
    those at N = b x t -- the decoder's others and the head)."""
    wide = plan_records(params["enc_blocks"]) + [
        blk["cross"][w]["w_plan"] for blk in params["dec_blocks"]
        for w in ("wk", "wv")]
    ids = {id(p) for p in wide}
    return wide, [p for p in plan_records(params) if id(p) not in ids]


def encdec_kernel_cases(params, dev) -> dict:
    """Phase 13: B1 (without an activation, and with the gelu on the up
    projection) and B2 on the served engine's own plans, at the N this
    slice's path gives them (3 at decode, 128 and 1,024 in the forward),
    against their plain versions (``hold_b1_b2``).  Returns kernel ->
    calls checked (these launches are not counted as the path's)."""
    import torch

    blk = params["dec_blocks"][0]
    cases = ((blk["mlp"]["up"]["w_plan"], (None, "gelu"), (3, 128, 1024)),
             (blk["mlp"]["down"]["w_plan"], (None,), (3, 128, 1024)),
             (blk["cross"]["wk"]["w_plan"], (None,), (1024,)),
             (params["lm_head"]["w_plan"], (None,), (3, 128)))
    gen = torch.Generator(device=dev).manual_seed(13)
    calls = {"bw_gemm_fused": 0, "bw_gemm": 0}
    for plan, acts, ns in cases:
        digits, mask = plan["digits"], plan["mask"]
        _, m_pad, k_pad = digits.shape
        for n in ns:
            x = torch.randn((n, k_pad), generator=gen, device=dev)
            hold_b1_b2(digits, mask, plan["sw_rows"], None, x, acts, calls,
                       f"M={m_pad} K={k_pad} N={n}",
                       block_m=m_pad // mask.shape[1],
                       block_k=k_pad // mask.shape[2], radix=4)
    return calls


def encdec_forward(eng, impl, toks, frames, first, dev, per_fwd) -> tuple:
    """Phase 13 (b): ``api.forward`` of ``toks`` over ``frames`` through
    a served engine's params: the route's kernel launched ``per_fwd``
    times and nothing else; finite logits of the right shape; against
    ``first`` (B1's logits, or None) within ENCDEC_ACT_GAP, greedy tokens
    equal but where the top-2 margin is within it.  From torch.profiler
    (``raw_profile``) over one more forward and over the priming alone
    (the encoder and the cross wk / wv: every call at N = b x f), the
    device ms and the kernel's ms at each N beside ``b1_bound_ms``.
    Returns (row, logits, failures)."""
    import torch
    from repro_torch.models import encdec as E

    cfg, failures = eng.cfg, []
    kern = FORWARD_ROUTES[impl]
    (b, t), f = toks.shape, frames.shape[1]
    what = f"forward impl={impl}"

    def forward():
        return eng.api.forward(eng.params, {"tokens": toks,
                                            "frontend": frames}, cfg, dev)[0]
    with torch.no_grad():
        eng.api.forward(eng.params, {"tokens": toks[:, :8],
                                     "frontend": frames}, cfg, dev)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        logits = forward()
        torch.cuda.synchronize()
        row = {"host_ms": 1e3 * (time.perf_counter() - t0),
               "launches": read_counts(),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        whole = raw_profile(forward)
        prime = raw_profile(lambda: E.encdec_prime_cross(eng.params, frames,
                                                         cfg, dev))
    sym = SYMBOLS[kern]
    wide, narrow = encdec_per_n(eng.params)
    bounds = (b1_bound_ms(wide, b * f), b1_bound_ms(narrow, b * t))
    row.update(device_ms=whole["device_ms"], kernels=whole["kernels"],
               kernel_ms=whole["kernel_ms"][sym], b1_bound_ms=sum(bounds))
    row["by_n"] = {
        str(b * f): {"calls": len(wide), "kernel_ms": prime["kernel_ms"][sym],
                     "b1_bound_ms": bounds[0]},
        str(b * t): {"calls": len(narrow),
                     "kernel_ms": whole["kernel_ms"][sym]
                     - prime["kernel_ms"][sym], "b1_bound_ms": bounds[1]}}
    want = {name: (per_fwd if name == kern else 0) for name in KERNELS}
    if row["launches"] != want:
        failures.append(f"{what}: launches {row['launches']}, expected "
                        f"{want}")
    if tuple(logits.shape) != (b, t, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits).all()):
        failures.append(f"{what}: bad logits {tuple(logits.shape)}")
    if first is not None:
        row["against_b1"] = lockstep_agreement(logits.float(), first.float())
        failures += act_gap_failures(row["against_b1"], what)
    return row, logits, failures


def act_gap_failures(lock, what) -> list:
    """B1 against B2 (``lockstep_agreement``): the largest logit gap and
    the top-2 margin at every flipped greedy token within
    ENCDEC_ACT_GAP."""
    if lock["max_logit_gap"] > ENCDEC_ACT_GAP or \
            any(m > ENCDEC_ACT_GAP for m in lock["margins"]):
        return [f"{what}: B1 and B2 part beyond ENCDEC_ACT_GAP "
                f"{ENCDEC_ACT_GAP}: {json.dumps(lock)}"]
    return []


def encdec_handoff(cfg, params, toks, frames, want, dev, variants) -> dict:
    """Phase 13 (c): ``encdec_prime_cross`` over ``frames``, then
    ``encdec_decode_step`` on each of ``toks`` (teacher-forced) from
    ``init_encdec_caches``, against ``want`` (the forward's logits), once
    a variant: None is the sound decode; "zero_cross" leaves the cross
    K/V zero, "swapped_cross" gives each request the other's,
    "shifted_cache" writes and reads each token at its position + 1.
    Per variant: tokens differing, their top-2 margins, the largest and
    the mean logit gap, the launches of the decode steps; and the
    priming's launches."""
    import torch
    from repro_torch.models import encdec as E

    b, t = toks.shape
    out = {}
    with torch.no_grad():
        zero_counts()
        cross = E.encdec_prime_cross(params, frames, cfg, dev)
        torch.cuda.synchronize()
        out["prime_launches"] = read_counts()
    for broken in variants:
        state = E.init_encdec_caches(cfg, b, t + 1, cfg.frontend_tokens,
                                     device=dev)
        if broken == "swapped_cross":
            state["xk"], state["xv"] = (cross[k].flip(1) for k in ("xk",
                                                                   "xv"))
        elif broken != "zero_cross":
            state["xk"], state["xv"] = cross["xk"], cross["xv"]
        shift = 1 if broken == "shifted_cache" else 0
        zero_counts()
        steps = []
        with torch.no_grad():
            for i in range(t):
                step, state = E.encdec_decode_step(
                    params, toks[:, i:i + 1],
                    torch.full((b,), i + shift, dtype=torch.int32,
                               device=dev), state, cfg)
                steps.append(step)
            torch.cuda.synchronize()
        out[broken] = decode_reading(torch.cat(steps, dim=1).float(), want,
                                     t)
        del state, steps
    return out


def encdec_decodes(eng, toks, frames, logits, dev, kern) -> tuple:
    """Phase 13 (c) on all the engine's decoder layers against (b)'s
    ``logits``, gated: the sound and the broken decodes
    (``encdec_handoff``) and their launches (priming 6 x encoder layers +
    2 x decoder layers, a step 8 x decoder layers + 1).  Returns (the
    readings, failures)."""
    cfg, failures = eng.cfg, []
    rows = encdec_handoff(cfg, eng.params, toks, frames, logits.float(), dev,
                          (None,) + ENCDEC_BROKEN)
    prime = rows.pop("prime_launches")
    n = 6 * cfg.n_encoder_layers + 2 * cfg.n_layers
    if prime != {name: n if name == kern else 0 for name in KERNELS}:
        failures.append(f"prime: launches {prime}, expected {n}")
    n = 8 * cfg.n_layers + 1
    for row in rows.values():
        if row["launches"] != {name: n * row["calls"] if name == kern
                               else 0 for name in KERNELS}:
            failures.append(f"decode: launches {row['launches']}, expected "
                            f"{n} a step")
    failures += decode_gate_failures(
        rows[None], {k: rows[k] for k in ENCDEC_BROKEN}, ENCDEC_LOGIT_ATOL,
        ENCDEC_MEAN_ATOL, "prime + decode against the forward")
    return {str(k): {key: r[key] for key in (
        "tokens_differ", "margins", "max_logit_gap", "mean_logit_gap")}
        for k, r in rows.items()}, failures


def encdec_config_phase(dev, log, kind) -> dict:
    """Phase 13: seamless-m4t-medium whole at its published widths (12
    encoder + 12 decoder layers, d_model 1024, 16 heads x 64, d_ff 4096,
    LayerNorm, an un-gated gelu MLP, an untied head of 256,256 rows),
    params from a seeded torch.Generator, through pallas_fused (B1),
    pallas (B2) and the planes oracle, TF32 off.  193 weights are
    planned (6 an encoder layer, 10 a decoder layer, the head;
    frontend_proj is a bf16 matmul, never planned); a decode step
    launches the route's kernel 8 x 12 + 1 = 97 times (the cross wk / wv
    run only when priming), a forward 193 times.  B1 and B2 are first
    held to their plain versions on the served plans at this path's N
    (``encdec_kernel_cases``).  (a) Served by ServeEngine (batch 3,
    ENCDEC_PROMPTS seeded prompts of 8-24 tokens, DENSE_NEW_TOKENS new
    tokens, max_len 32; the last request reuses a slot) against the zero
    cross K/V, as the reference serves: B1's lock-step logits within
    ENCDEC_ACT_GAP of B2's (``act_gap_failures``); the oracle, which
    rounds the up projection to bf16 before the gelu (C7), logged
    against B1 with the top-2 margin at each flip; on B1 the request in
    the reused slot emits the tokens it emits alone on a fresh engine;
    ms/step, device and B1 ms a step, the head's B1 launch beside its
    bound, kernels a step, peak GB, planning seconds.  (b) The forward of
    ENCDEC_FORWARD_SIZE seeded tokens over as many rows of 512 seeded
    frames, on B1 and B2 (``encdec_forward``).  (c) On B1, prime +
    teacher-forced decode against (b)'s forward (``encdec_decodes``).
    (d) On B1, loss_fn on (b)'s batch (``rwkv_loss``)."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import get_api
    from repro_torch.serving.engine import state_leaves

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("phase 13: TF32 is on for float32 matmuls")
    cfg = get_config(ENCDEC_ARCH)
    b, t = ENCDEC_FORWARD_SIZE
    f = cfg.frontend_tokens
    per_step = 8 * cfg.n_layers + 1
    per_fwd = 6 * cfg.n_encoder_layers + 10 * cfg.n_layers + 1
    free_device_memory()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = get_api(cfg).init(gen, cfg, dev)
    frames = torch.randn((b, f, cfg.d_model), generator=gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in state_leaves(params))
    tag = f"[encdec] {ENCDEC_ARCH}"
    log(f"{tag}: {n_params / 1e9:.3f} B params (param_count "
        f"{cfg.param_count() / 1e9:.3f} B) drawn in {init_s:.2f} s  "
        f"({kind})")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(8, 25)))
               .tolist() for _ in range(ENCDEC_PROMPTS)]
    rng = np.random.default_rng(11)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, t + 1)),
                           device=dev)
    failures, runs, seqs, first = [], {}, None, None
    for impl in ("pallas_fused", "pallas", "planes"):
        kern = FORWARD_ROUTES[impl]
        eng, run, fails = serve_route(cfg, params, impl, prompts, seqs, dev,
                                      per_step, "lm_head", planned=per_fwd)
        failures += fails
        if impl == "pallas_fused":
            seqs = [q + o for q, o in zip(prompts, run["tokens"])]
            checked = encdec_kernel_cases(eng.params, dev)
            log(f"{tag}: B1 (gelu on up) and B2 on the served plans at N "
                f"3, 128, 1024 equal their plain versions: "
                f"{json.dumps(checked)} calls")
        shown = {k: v for k, v in run.items()
                 if k not in ("tokens", "lockstep")}
        log(f"{tag} impl={impl} served: {json.dumps(shown)}  ({kind})")
        if kern:
            run["forward"], logits, fails = encdec_forward(
                eng, impl, toks[:, :t], frames, first, dev, per_fwd)
            failures += fails
            log(f"{tag} forward impl={impl} batch {b} x {t} tokens over "
                f"{b} x {f} frames: {json.dumps(run['forward'])}  ({kind})")
        if impl == "pallas_fused":
            first = logits
            run["decode"], fails = encdec_decodes(eng, toks[:, :t], frames,
                                                  logits, dev, kern)
            failures += fails
            log(f"{tag} prime + {t} teacher-forced decode steps against the "
                f"forward on {cfg.n_layers} decoder layers (gate: largest "
                f"{ENCDEC_LOGIT_ATOL}, mean {ENCDEC_MEAN_ATOL}): "
                f"{json.dumps(run['decode'])}  ({kind})")
            run["loss"], fails = rwkv_loss(eng, toks[:, :t], toks[:, 1:t + 1],
                                           logits, dev, frontend=frames)
            failures += fails
            log(f"{tag} loss_fn, labels at every position: "
                f"{json.dumps(run['loss'])}  ({kind})")
        if kern:
            del logits
        del eng
        if impl == "pallas_fused":
            failures += fresh_slot_check(cfg, params, impl, prompts, run,
                                         dev, per_step, log, tag)
        runs[impl] = run
    del first
    kernel = runs["pallas_fused"]
    b1_lock = kernel.pop("lockstep")
    lock_b2 = lockstep_agreement(b1_lock, runs["pallas"].pop("lockstep"))
    lock_b2["served_tokens_equal"] = \
        runs["pallas"]["tokens"] == kernel["tokens"]
    log(f"{tag}: pallas (B2) against pallas_fused (B1) in lock step (gate "
        f"ENCDEC_ACT_GAP {ENCDEC_ACT_GAP}): {json.dumps(lock_b2)}")
    failures += act_gap_failures(lock_b2, "served, in lock step")
    lock = lockstep_agreement(b1_lock, runs["planes"].pop("lockstep"))
    lock["served_tokens_equal"] = runs["planes"]["tokens"] == kernel["tokens"]
    log(f"{tag}: the planes oracle against pallas_fused in lock step "
        f"(logged, not gated: C7): {json.dumps(lock)}")
    del params, frames, b1_lock
    free_device_memory()
    if failures:
        raise AssertionError("phase 13: " + "; ".join(failures))
    return {"layers": cfg.n_layers, "init_s": init_s, "per_step": per_step,
            "per_forward": per_fwd, "oracle": lock, "b2": lock_b2, **runs}


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rival-wide", metavar="QUANT_GEMM_CU",
                        action="append", default=[],
                        help="another design's csrc/quant_gemm.cu (its wide "
                             "kernel meeting stream-K), checked and timed "
                             "beside the shipped wide B8/B9 kernel at T=512 "
                             "(phase 3); may be given more than once")
    args = parser.parse_args(argv)
    started = time.perf_counter()
    print(card_line(), flush=True)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.configs.minicpm_2b import CONFIG
    from repro_torch.kernels import _build
    from repro_torch.models.api import get_api

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build: one nvcc per source, all started together ----------------
    t0 = time.perf_counter()
    _build.load_all()
    log(f"[build] {', '.join(_build.SOURCES)}: "
        f"{time.perf_counter() - t0:.1f} s")
    spills = []
    for name in _build.SOURCES:
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            if any(w in line for w in ("Function properties", "registers",
                                       "spill")):
                log(f"  {line.strip()}")
            if "spill" in line and not line.strip().endswith(
                    "0 bytes spill stores, 0 bytes spill loads"):
                spills.append(f"{name}: {line.strip()}")
    if spills:
        raise AssertionError(f"ptxas reports spills: {spills}")

    # -- 3. kernels against their plain versions -----------------------------
    t0 = time.perf_counter()
    log("[kernels] bit-exact and timed against the plain versions")
    floor = floor_ms()
    log(f"  floor_ms {floor:.5f}: cuda_ms of an empty launch")
    per_kernel, err = kernel_cases(dev, log)
    for rows, errs in (sparse_cases(dev, log),
                       baseline_cases(dev, log, args.rival_wide)):
        per_kernel.update(rows)
        err.update(errs)
    log(f"  B1-B4 walk edges: {walk_cases(dev, log)} cases")
    dense_edge_cases(dev, log)
    log(f"[kernels] phase 3 in {time.perf_counter() - t0:.1f} s")

    # -- 4. the path at full width -------------------------------------------
    cfg = CONFIG
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size,
                            int(rng.integers(8, 25))).tolist()
               for _ in range(8)]
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = get_api(cfg).init(gen, cfg, dev)
    torch.cuda.synchronize()
    log(f"[path] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.padded_vocab}; params "
        f"{cfg.param_count() / 1e9:.3f} B in "
        f"{time.perf_counter() - t0:.1f} s")
    # (plane budget, impl) -> the kernel its run must launch, or None
    routes = {(3, "pallas_fused"): "bw_gemm_fused", (3, "pallas"): "bw_gemm",
              (3, "planes"): None, (2, "pallas_fused"): "bw_gemm_fused",
              (2, "pallas_sparse"): "bw_gemm_sparse_fused",
              (2, "pallas_pipelined"): "bw_gemm_sparse_fused_pipelined"}
    runs = {}
    for (planes, impl), kern in routes.items():
        spec = f"planes={planes},encoding=ent,act_quant=per_token,impl={impl}"
        tokens, stats = serve(cfg, params, spec, prompts, dev)
        runs[planes, impl] = {"tokens": tokens, "stats": stats}
        log(f"[path] planes={planes} impl={impl}: "
            f"{stats['generated_tokens']} tokens in "
            f"{stats['engine_steps']} steps, {stats['tok_per_s']:.2f} "
            f"tok/s, {stats['ms_per_step']:.3f} ms/step, peak "
            f"{stats['peak_mem_gb']:.2f} GB, set-up {stats['setup_s']:.1f} s,"
            f" launches {stats['launches']}  ({kind})")
        log(f"[profile] planes={planes} impl={impl}: "
            f"{json.dumps(stats['profile'])}")
        per_step = stats["profile"].get("kernel_ms_per_step", {})
        if kern in SYMBOLS and SYMBOLS[kern] in per_step:
            ops_step = stats["profile"]["kernel_ops_per_step"][SYMBOLS[kern]]
            log(f"[profile] planes={planes} impl={impl}: {kern} "
                f"{per_step[SYMBOLS[kern]]:.3f} ms a step, "
                f"{1e3 * per_step[SYMBOLS[kern]] / (7 * cfg.n_layers):.2f} "
                f"us a launch; {ops_step:g} of its device operations a "
                f"step for {7 * cfg.n_layers} calls  ({kind})")
        if "unfused" in stats:
            log(f"[path] planes={planes} impl={impl} unfused route: "
                f"{json.dumps(stats['unfused'])}")
        want = 7 * cfg.n_layers * stats["engine_steps"]
        expect = {name: want if name == kern else 0 for name in KERNELS}
        if stats["launches"] != expect:
            raise AssertionError(f"planes={planes} impl={impl}: launches "
                                 f"{stats['launches']}, expected {expect}")
        if any(len(t) != 16 for t in tokens):
            raise AssertionError(f"planes={planes} impl={impl}: a request "
                                 f"did not generate 16 tokens")
    for planes, impl in routes:
        base = runs[planes, "pallas_fused"]["tokens"]
        if runs[planes, impl]["tokens"] != base:
            raise AssertionError(f"planes={planes} impl={impl} tokens "
                                 f"differ from impl=pallas_fused")
    for impl, kern in (("pallas_sparse", "bw_gemm_sparse"),
                       ("pallas_pipelined", "bw_gemm_sparse_pipelined")):
        unfused = runs[2, impl]["stats"]["unfused"]
        expect = {name: unfused["weights"] if name == kern else 0
                  for name in KERNELS}
        if unfused["launches"] != expect:
            raise AssertionError(f"{impl} unfused route: launches "
                                 f"{unfused['launches']}, expected {expect}")
    log("[path] planes=3: pallas_fused, pallas and planes emit the same "
        "tokens; planes=2: pallas_fused, pallas_sparse and pallas_pipelined"
        f" emit the same tokens; phase 4 in {time.perf_counter() - t0:.1f} s")

    # -- 5. the kernel-level API on every weight of the model ----------------
    t0 = time.perf_counter()
    api = kernel_api_pass(params, dev, log)
    api_s = time.perf_counter() - t0
    n_w = api["weights"]
    if n_w != 7 * cfg.n_layers:
        raise AssertionError(f"kernel API pass: {n_w} weights, expected "
                             f"{7 * cfg.n_layers}")
    expect = {"plain": {name: n_w if name in ("ent_encode", "quant_gemm",
                                              "quant_gemm_fused", "bw_gemm",
                                              "bw_gemm_fused") else 0
                        for name in KERNELS},
              "silu": {name: n_w if name in ("quant_gemm_fused",
                                             "bw_gemm_fused") else 0
                       for name in KERNELS}}
    if api["launches"] != expect:
        raise AssertionError(f"kernel API pass: launches {api['launches']},"
                             f" expected {expect}")
    log(f"[api] {n_w} weights in {api_s:.1f} s: kernel-encoded plans equal "
        f"the oracle's; quant_gemm == bw_gemm and quant_gemm_fused == "
        f"bw_gemm_fused bit for bit; with silu max |diff| "
        f"{api['silu_max_abs_diff']} (bit-identical: "
        f"{api['silu_bit_identical']}); host s to plan all {n_w}: "
        f"encode_impl=kernel {api['plan_s']['kernel']:.3f}, ref "
        f"{api['plan_s']['ref']:.3f} (both sort rows by the oracle's "
        f"digits: the kernel replaces one of two encodes a weight); "
        f"launches {json.dumps(api['launches'])}  ({kind})")

    # -- 6. the serving stack: tiers, the async server, failover -----------
    t0 = time.perf_counter()
    srv = server_phase(*first_layers(cfg, params, SERVER_DEPTH), dev, log,
                       kind)
    log(f"[server] phase 6 in {time.perf_counter() - t0:.1f} s; B1 "
        f"launches in the virtual run {srv['virtual_launches']['bw_gemm_fused']}"
        f"; peak {srv['server_peak_gb']:.2f} GB  ({kind})")

    # -- 7. the static analyzers and the measured autotuner ------------------
    tuned = autotune_phase(cfg, params, dev, log, kind, prompts[:3],
                           runs[2, "pallas_fused"]["tokens"][:3])
    log(f"[autotune] phase 7 in {tuned['seconds']:.1f} s: "
        f"{json.dumps(tuned['serving'])}")

    # -- 8. the full-sequence forward and the dense configs ------------------
    t0 = time.perf_counter()
    wide_cases(dev, log)
    forward_phase(cfg, params, dev, log, kind)
    del params
    free_device_memory()
    dense = dense_config_phase(dev, log, kind)
    log(f"[dense] phase 8 in {time.perf_counter() - t0:.1f} s; B1 launches "
        f"{json.dumps({a: r['pallas_fused']['launches']['bw_gemm_fused'] for a, r in dense.items()})}"
        f"; peak GB {json.dumps({a: round(r['pallas_fused']['peak_gb'], 2) for a, r in dense.items()})}"
        f"  ({kind})")

    # -- 9. the MoE configs --------------------------------------------------
    t0 = time.perf_counter()
    moes = moe_config_phase(dev, log, kind)
    moe_launches = {a: r["pallas_fused"]["launches"]["bw_gemm_fused"]
                    for a, r in moes.items()}
    log(f"[moe] phase 9 in {time.perf_counter() - t0:.1f} s; B1 launches "
        f"{json.dumps(moe_launches)}"
        f"; peak GB {json.dumps({a: round(r['pallas_fused']['peak_gb'], 2) for a, r in moes.items()})}"
        f"  ({kind})")

    # -- 10. the VLM config --------------------------------------------------
    t0 = time.perf_counter()
    vlm = vlm_config_phase(dev, log, kind)
    vlm_launches = vlm["pallas_fused"]["launches"]["bw_gemm_fused"]
    log(f"[vlm] phase 10 in {time.perf_counter() - t0:.1f} s; B1 launches "
        f"served {vlm_launches}; peak GB "
        f"{round(vlm['pallas_fused']['peak_gb'], 2)} (B1), "
        f"{round(vlm['planes']['peak_gb'], 2)} (oracle)  ({kind})")

    # -- 11. the RWKV config -------------------------------------------------
    t0 = time.perf_counter()
    rwkv = rwkv_config_phase(dev, log, kind)
    served = rwkv["pallas_fused"]
    rwkv_launches = served["launches"]["bw_gemm_fused"] + \
        served["fresh"]["launches"]["bw_gemm_fused"]
    log(f"[rwkv] phase 11 in {time.perf_counter() - t0:.1f} s; B1 launches "
        f"served {rwkv_launches}; peak GB {round(served['peak_gb'], 2)} "
        f"(B1), {round(rwkv['planes']['peak_gb'], 2)} (oracle)  ({kind})")

    # -- 12. the hybrid config -----------------------------------------------
    t0 = time.perf_counter()
    hybrid = hybrid_config_phase(dev, log, kind)
    served = hybrid["pallas_fused"]
    hybrid_launches = served["launches"]["bw_gemm_fused"] + \
        served["fresh"]["launches"]["bw_gemm_fused"]
    log(f"[hybrid] phase 12 in {time.perf_counter() - t0:.1f} s; B1 "
        f"launches served {hybrid_launches}; peak GB "
        f"{round(served['peak_gb'], 2)} (B1), "
        f"{round(hybrid['planes']['peak_gb'], 2)} (oracle)  ({kind})")

    # -- 13. the encoder-decoder config --------------------------------------
    t0 = time.perf_counter()
    encdec = encdec_config_phase(dev, log, kind)
    served = encdec["pallas_fused"]
    encdec_launches = served["launches"]["bw_gemm_fused"] + \
        served["fresh"]["launches"]["bw_gemm_fused"]
    encdec_b2_launches = encdec["pallas"]["launches"]["bw_gemm"]
    log(f"[encdec] phase 13 in {time.perf_counter() - t0:.1f} s; B1 "
        f"launches served {encdec_launches}, B2 {encdec_b2_launches}; peak "
        f"GB {round(served['peak_gb'], 2)} (B1), "
        f"{round(encdec['pallas']['peak_gb'], 2)} (B2), "
        f"{round(encdec['planes']['peak_gb'], 2)} (oracle)  ({kind})")
    log(f"[total] phases 2-13 in {time.perf_counter() - started:.1f} s")

    # -- the kernels line ----------------------------------------------------
    replaces = {"bw_gemm_fused": "src/repro/kernels/bw_gemm.py:215",
                "bw_gemm": "src/repro/kernels/bw_gemm.py:140",
                "bw_gemm_sparse_fused": "src/repro/kernels/bw_gemm.py:393",
                "bw_gemm_sparse": "src/repro/kernels/bw_gemm.py:316",
                "bw_gemm_sparse_fused_pipelined":
                    "src/repro/kernels/bw_gemm.py:678",
                "bw_gemm_sparse_pipelined":
                    "src/repro/kernels/bw_gemm.py:583",
                "ent_encode": "src/repro/kernels/encode.py:46",
                "quant_gemm_fused": "src/repro/kernels/quant_gemm.py:80",
                "quant_gemm": "src/repro/kernels/quant_gemm.py:33"}
    launches = {"bw_gemm_fused": runs[3, "pallas_fused"],
                "bw_gemm": runs[3, "pallas"],
                "bw_gemm_sparse_fused": runs[2, "pallas_sparse"],
                "bw_gemm_sparse_fused_pipelined": runs[2, "pallas_pipelined"]}
    unfused = {"bw_gemm_sparse": runs[2, "pallas_sparse"],
               "bw_gemm_sparse_pipelined": runs[2, "pallas_pipelined"]}
    def layer_sums(name, n):
        """One layer's seven calls of a kernel at N=n (B7: its one row a
        shape), summed per key; None where a call has no number."""
        rows = [r for r in per_kernel[name] if r["n"] in (n, None)]
        out = {}
        for key in ("ms", "plain_ms", "library_ms", "bytes", "ops"):
            vals = [r[key] for r in rows]
            out[key] = None if any(v is None for v in vals) else sum(
                v * r["per_layer"] for v, r in zip(vals, rows))
        return out

    wide = {}
    for name in ("bw_gemm_fused", "bw_gemm", "quant_gemm_fused",
                 "quant_gemm"):
        sums = layer_sums(name, 512)
        sums["bound_ms"] = 1e3 * max(sums["bytes"] / HBM_BYTES_PER_S,
                                     sums["ops"] / INT8_OPS_PER_S)
        wide[name] = sums
    log(f"[kernels] one layer's seven calls at N=512: {json.dumps(wide)}")
    bar = {name: layer_sums(name, 4)["ms"]
           for name in (B1_PLANES2, "bw_gemm_sparse_fused")}
    stream = {name: sum(r["stream_ms"] * r["per_layer"]
                        for r in per_kernel[name] if r["n"] == 4)
              for name in ("bw_gemm_fused", "bw_gemm_sparse_fused")}
    log(f"[kernels] one layer's seven calls at N=4 on the planes=2 plan: "
        f"bw_gemm_fused {bar[B1_PLANES2]:.4f} ms, bw_gemm_sparse_fused "
        f"{bar['bw_gemm_sparse_fused']:.4f} ms; stream_ms of the live "
        f"digits: planes=3 {stream['bw_gemm_fused']:.4f}, planes=2 "
        f"{stream['bw_gemm_sparse_fused']:.4f}; floor_ms x 7 "
        f"{7 * floor:.4f}  ({kind})")
    kernels = []
    for name in KERNELS:
        sums = layer_sums(name, 4)
        bytes_ms = 1e3 * sums["bytes"] / HBM_BYTES_PER_S
        ops_ms = 1e3 * sums["ops"] / INT8_OPS_PER_S
        if name in launches:
            count = launches[name]["stats"]["launches"][name]
            if name == "bw_gemm_fused":
                count += sum(moe_launches.values()) + vlm_launches + \
                    rwkv_launches + hybrid_launches + encdec_launches
            elif name == "bw_gemm":
                count += encdec_b2_launches
        elif name in unfused:
            count = unfused[name]["stats"]["unfused"]["launches"][name]
        else:
            count = api["launches"]["plain"][name]
        source = {"bw_gemm_fused": "bw_gemm.cu", "bw_gemm": "bw_gemm.cu",
                  "ent_encode": "encode.cu",
                  "quant_gemm_fused": "quant_gemm.cu",
                  "quant_gemm": "quant_gemm.cu"}.get(name,
                                                     "bw_gemm_sparse.cu")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces[name], "launches": count,
            "max_abs_err": err[name],
            "ms": sums["ms"], "plain_ms": sums["plain_ms"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": sums["library_ms"], "floor_ms": floor})
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
