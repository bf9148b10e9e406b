#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order (any failure raises and the script exits non-zero):

1. device  -- require CUDA; print the card's name and power limit;
2. build   -- compile the port's CUDA kernels from ``deepspeed_tpu_torch/
              csrc`` (one ``nvcc`` per source, in parallel), timed; print
              the ptxas report (registers, stack and spill bytes; a spill
              fails the run) and shared memory of kernels D, E and F, of
              A and B in each pool mode, of C and of I's decode and flash
              regimes per head dim (64, 96, 128, 256), of G/H's decode
              kernel per
              weight width and row tile (8 or 16 rows), and of G/H's
              multi-row kernel per weight width;
3. kernels -- kernels A-D at the serving path's Llama-3-8B shapes (H=32,
              K=8, d=128, block 128) on seeded random bf16 inputs, each held
              against its plain PyTorch version (atol = rtol = 2e-2 on
              normalised outputs, 1e-2 on m / lse; D's out per 64-row tile
              like dq/dk/dv below) and timed: the kernel alone (its
              launcher on arguments prepared once; A, B and C, shorter
              than their launch from Python, from a CUDA graph of
              launches), the whole wrapper, its
              plain version, its bound and, for D, SDPA (in turns: SDPA,
              kernel, kernel, SDPA); the int8 and int4 modes of A and B on
              the same atoms over the pools quantized by
              ``packed_kv_append_quant``; B in each pool mode and C one
              launch on the card a call (the profiler's count) and bit for
              bit against a second launch; B then C over a 1024-token
              prompt chunked at 256, 512 and 768 (its past in a shuffled
              bf16 pool) bit for bit against D over the whole prompt; G on the
              llama3-8b head (B=6, D=4096, F=128256) and H at layer 2 of a
              stack of each layer product -- wqkv (D=4096, F=6144), wo
              (4096, 4096), w_gateup (4096, 28672), w_down (14336, 4096)
              -- at B=6 and B=256, and of w_gateup at B=1 and B=16 too,
              int4 and int8, beside cuBLAS on the dense bf16 weights (the
              decode rows, B <= 16, cycle over layers and dense copies
              spanning three times L2, so every launch reads HBM, and are
              timed from CUDA graphs of launches, each call one launch on
              the card by the profiler's count; the B=256 rows cycle over
              four layers); B=256 outputs also per 64-row tile like
              dq/dk/dv below, and every output bit for bit against a
              second launch;
              then the training shapes: D (held and timed as above) and
              the backward kernels E (dq) and F (dk, dv) at Llama-3.2-1B's
              B=4 T=2048 H=32 K=8 d=64 (causal) and at d=128 (B=1),
              dq/dk/dv held per 64-row tile
              (each batch row and head: max abs error <= 2e-2 x that
              tile's max |plain|), timed likewise beside one SDPA backward
              (its backend named; E then F in turns with it, as one
              ratio); kernel I at the serve shapes (a t=1
              tile over 8 slots at A's pasts -- its decode regime, timed
              from a CUDA graph of launches -- and a t=700 tile over 4
              slots from position 0 -- its flash regime; its output held
              per 64-row tile like dq/dk/dv, each call one launch on the
              card by the profiler's count, two launches bit for bit), J
              on [4096, 4096] and [6, 4096] bf16 and [4096, 4096] fp32
              rows (forward, and the autograd backward
              against the plain version's; 1e-2 bf16, 1e-5 fp32, beside
              ``F.rms_norm``) and K on the probe's 256 MB array (relative
              1e-6, beside ``torch.sum``); A-F and I again at phi3-mini's
              heads (H = K = 32, d = 96) and pythia-1b's (H = K = 8,
              d = 256), the same checks, rows ending /d96 and /d256 (E, F
              at B=1 T=2048); then J's and K's entry points
              with the counts at 0 -- ``measure_hbm_bandwidth()``, whose
              copy and stream rates are printed beside the data sheet's
              3.35 TB/s, and the op builder's RMSNorm -- each must launch;
4. serve   -- ``InferenceEngineV2`` on ``llama3-8b`` at full width and depth
              (random bf16 weights from seed 0, rescaled so attention
              weighs in the residual stream; max_seq_len cut to 2048,
              8 slots, block 128): whole-prompt ``put`` of four prompts,
              a mixed ``put`` step (four decode tokens + two fresh prompts
              of 300 and 1100 tokens, chunked), ``decode_batch(steps=32)``
              over all six. Every kernel must launch in this phase; the
              first call of each in the two ``put`` steps, and the first
              ``decode_batch`` call of kernel A whose rows have moved past
              the pool frontier, are replayed through the plain versions;
              the 1100-token prompt's chunked last-token logits must match
              a whole-prompt ``put`` of it (relative L2 <= 2e-2, bf16);
              the engine is freed afterwards;
5. train   -- ``deepspeed_tpu_torch.initialize`` on ``llama3-1b`` at full
              width and depth (max_seq_len 2048; random fp32 master weights
              from seed 0, bf16 compute): micro-batch 4 x 2048 tokens, GA 2,
              AdamW (lr 1e-4, wd 0.1), gradient clipping 1.0; four
              ``train_batch`` steps on one fixed numpy-seeded batch, then one
              ``fused_train_step``. Every loss and grad norm must be finite,
              the last loss below the first, and kernels D, E and F must
              launch; the first launch of each is replayed through its plain
              version. Then a gradient cross-check at 2 layers of the same
              width: the gradients of wq, wk, wv, wo and the embedding
              through the kernels against those through the plain attention
              (this script swaps it in), relative L2 <= 2e-2 per leaf.
              Prints step ms, tokens/s and the model-FLOPs share of
              989 TFLOP/s (6 N + 12 L T D FLOPs per token). The model
              configuration, the engine config and the batch come from
              ``deepspeed_tpu_torch/tools/train_profile.py``, which
              profiles the same step.

6. serve-quant -- ``InferenceEngineV2`` on ``llama3-8b`` at full width
              and depth from phase 4's weights, twice, each engine freed
              after: Q1 ``weight_dtype="int4", kv_dtype="int8"`` and Q2
              ``weight_dtype="int8", kv_dtype="int4"``, on phase 4's traffic.
              G, H and the pool's A/B int modes must launch; the first
              launch of each in the whole-prompt ``put``, the mixed ``put``
              and ``decode_batch`` is replayed through its plain version.
              Prints the tokens/s, the served tree's bytes against bf16,
              peak memory, and (no gate) the whole-prompt logits' rel L2
              against phase 4's. Then the weight cross-check at 2 layers of
              the same width: int8 and int4 weights through G/H against an
              engine served the dense bf16 weights they dequantize to,
              last-token logits rel L2 <= 2e-2.

7. serve-dense -- ``llama3-8b`` at full width and depth on phase 6's weights
              (one bf16 tree that every engine shares, none copies),
              ``max_seq_len`` 2048, 8 slots, block 128: (c)
              ``init_inference(model, params=tree)`` runs ``forward`` and a
              greedy ``generate`` of 16 tokens on four 128-token prompts,
              every step's logits captured; a packed engine runs phase 4's
              four prompts in one ``put`` and 16 single-token ``put`` steps
              on its own argmax, then the four 128-token prompts and one
              ``put`` per token ``generate`` chose; (a) ``packed=False``
              (kernel I) and (b) ``paged=False`` run phase 4's traffic fed
              the same tokens, every logits vector finite, I's first launch
              replayed through ``plain_paged_attention`` per 64-row tile;
              then the op builder's RMSNorm on the card. I and J must
              launch. Against the packed engine, relative L2 of every
              logits vector: ``forward`` <= 2e-2 (the same kernels);
              (a), (b) and (c)'s ``generate`` steps within limits that lie
              between their sound readings and those of controls that
              drop each row's newest visible column from their attention
              (kernel I's wrapper for (a), the dense cache's attention for
              (b) and (c)), each control past twice its limit; the packed
              engine's own bf16 noise floor (its prompts put one at a
              time) is printed beside them. Then the same at 2 layers of
              the same width (seed-0 weights at the init scale) with the
              gate at 2e-2 for all of them. Prints the prompt put's
              tokens/s and the decode put's ms for each engine.

8. head-dims -- ``phi3-mini`` (d = 96) and ``pythia-1b`` (d = 256) at full
              width and depth (seed-0 bf16 weights, ``attention_heavy``;
              max_seq_len 2048, 8 slots, block 128) on phase 4's traffic,
              each over a bf16 pool and an int pool (phi3-mini int8,
              pythia-1b int4): finite logits, every kernel of the path
              launched, first launches replayed through the plain
              versions, chunked vs whole (bf16 pool) at rel L2 2e-2; the
              ``packed=False`` engine (kernel I) against the packed one at
              2 layers at rel L2 2e-2; training on kernels D, E, F
              (pythia-1b at full depth, phi3-mini at 2 layers; micro-batch
              2 x 2048, 3 ``train_batch`` steps): finite, falling losses,
              replays, and the 2-layer per-leaf gradient cross-check at
              2e-2. Every attention kernel must launch in this phase.

9. serve-features -- ``InferenceEngineV2``'s serving features on
              ``llama3-8b`` at full width and depth over phase 4's weights
              (rebuilt from seed 0 and checked equal to phase 4's tree by
              a sampled fingerprint; one bf16 tree every engine shares,
              none copies;
              max_seq_len 2048, 8 slots, block 128). (a) prefix cache: a
              1024-token shared prefix with suffixes of 37, 128, 129 and
              300 tokens, the first prompt put alone and then the other
              three, on an engine with ``prefix_cache`` (tiers on) and on
              one without, then ``decode_batch(steps=16)``: the warm puts
              hit 1024 tokens each and launch B, last-token logits warm
              vs cold within rel L2 2e-2, greedy tokens identical. (b)
              tiers: every cache block demoted (48 MB host budget, the
              rest to NVMe under a temporary directory removed at the
              end), then a prefix attach promotes the 8 prefix blocks:
              their pool bytes equal the bytes before the demote
              (``torch.equal``) and the logits equal a warm attach before
              the demote bit for bit; ms per block each way printed. (c)
              speculative: four prompts that repeat a 23-token phrase,
              ``decode_batch(steps=32, speculative=True)`` against
              ``False``, and one ``spec_decode_round`` verifying the fused
              loop's next four tokens as drafts; where tokens part, a
              teacher-forced ``put`` must put the fused token and every
              speculative token from there on within 0.25 standard
              deviations of the logits below the argmax (printed with
              the step).
              (d) pause/resume: one of four requests paused and resumed
              between two of three ``decode_batch`` calls gives the tokens
              of an unpaused run bit for bit (bf16 and int8 pools); the
              same request exported after the first call and adopted by a
              second engine over the same tree gives them too. (e)
              sampling (temperature 0.8, top-k 50, top-p 0.9): one seed
              twice gives the same tokens, another seed others, and
              ``temperature=0`` gives (a)'s greedy tokens. A, B, C and D
              must launch; the first launch of D (cold put), B and C (warm
              put, then the speculative verify) and A (past the frontier
              in ``decode_batch``) is replayed through the plain version.

10. observability -- the engine's instruments on phase 9's model and
              tree (no new tree, no copy): after a fresh process registry
              (``set_registry(None)``) and with tracing on, a prefix-cache
              engine with phase 9's tier settings and ``enable_metrics()``
              runs phase 9 (a)'s traffic. Gates: its greedy tokens equal
              phase 9 (a)'s (hooks off) bit for bit; the registry reads
              the traffic (``inference/tokens`` = prompt tokens less the
              prefix hits, ``decode_tokens`` = 4 x 16, 1024 hit tokens
              per warm request); device launches of a 4-sequence decode
              ``put`` (the profiler's count, :func:`device_launches`) are
              equal with the hooks on and off (the medians of three
              traces each, taken in turn); a ``ProfileTrigger`` armed
              by its trigger file (warm-up 1, 2 capture steps, ``check``
              after each ``decode_batch``) writes a ``torch.profiler``
              trace naming kernel A (``paged_decode_kernel``); a
              ``resume_io_error`` pinned to ``nvme`` unwinds a resume (the
              injector's ``fired`` list holds it, the uid is gone); every
              cache block demoted and the prefix promoted back: the tier
              demotion counters equal the blocks demoted and paused, the
              ``prefix_cache_tier_promote_ms`` counts the blocks promoted;
              a clean pause/resume gives an unpaused run's tokens; no
              block leaked; the exported trace passes ``validate_trace``
              with no repaired pair; ``flight_dump`` writes a file under a
              temporary directory that reads back the events. Prints the
              p50 and p90 of ``inference/put_host_ms``, ``put_fetch_ms``
              and ``decode_fetch_ms`` and of the puts' ``dispatch_ms``,
              beside the card's name and power limit.

11. serving -- the serving stack above the engine on phase 9's model and
              tree (no new tree, no copy): two ``InferenceEngineV2``
              replicas (max_seq_len 2048, 8 slots, block 128), each under a
              ``ContinuousBatcher`` (prefill_chunk 256) on its own
              ``Replica`` thread, behind one ``ReplicaRouter`` and one
              ``ServingFrontend`` on 127.0.0.1 (an ephemeral port); every
              request through ``GenerateClient`` over real sockets,
              prompts of 300-1100 tokens (numpy seeds 11-14). (a) one unary
              request alone (its first chunk takes D), then 5 unary
              requests and 2 SSE streams at once (prompt chunks beside
              decode atoms: B, C and A), 16 new tokens each: all complete,
              each stream's tokens equal its end record's; (b) four
              batch-tier streams (32 tokens), two on each replica, held
              mid-decode (each replica's worker freezes at the step where
              both its requests decode), then a latency-tier request and a
              ``preempt_storm`` of two firings (the reference's slo-storm
              lever: admission never lets block pressure pass the
              watermark): at least one batch request paused (KV demoted
              to the host tier), resumed and completed, the latency
              request completed; (c) max_queue_depth 2: with the workers
              frozen, the request over the queues gets 429 with a
              Retry-After header, and one with a past-due deadline 504;
              (d) with migration on a temporary shared directory, four
              streams of 32 tokens held mid-decode as in (b) and four of
              16 queued behind them, then SIGTERM through the router's
              handler drains r0, as the reference's drain does: its two
              in-flight requests complete on r0, its queued ones move to
              r1 (one ``migrated`` event each, no failure) and complete
              there, r0 ends drained and the injector holds no fault.
              After each part: the socket refuses connections,
              every thread the part started has ended (joins have time
              limits), both pools are whole with nothing live or paused,
              the shared namespace is empty. A, B, C and D must launch;
              the first launch of each is replayed through its plain
              version; every served token lies within ``SPEC_GAP_SD`` of
              the teacher-forced argmax (the prompts put eight at a time,
              then the served tokens fed one step at a time). Prints the
              p50 and p90 of ``serving/ttft_ms`` and ``serving/tpot_ms``
              from the registry, beside the card's name and power limit.

12. fleet -- the elastic fleet (``FleetController`` over a
              ``WarmStartCache``) at ``llama3-8b`` full width and depth,
              int4 weights and an int8 pool (phase 6's Q1), engines of
              max_seq_len 2048, 8 slots, block 128, batchers chunking
              prompts at 256, every replica built through one cache in a
              temporary directory and sharing one migration namespace
              there; the first build inits a fresh model from seed 0 and
              quantizes it, every later one comes through the cache. (a) r0
              builds cold and publishes its quantized tree; a warm build
              reads it back: every leaf ``torch.equal`` to r0's, the greedy
              tokens of two prompts equal r0's; an injected
              ``weight_load_io_error`` and a corrupt manifest each build
              cold. Prints the cold, publish and warm ms, the warm
              stream's GB/s and the temporary directory's filesystem. (b)
              ``replica_crash`` on r0 during a storm of 8 prompts of
              300-1100 tokens (16 new tokens each) over two replicas: every
              admitted uid terminal, r0 respawned warm under its name with
              a new incarnation and readmitted, a new request served, one
              flight dump. (c) the reference drill's burst (48 requests, 16
              tokens) on one replica with min 1, max 3, 2 queued per
              replica, 2 pressured polls up, 3 idle polls down: the pool
              grows and shrinks back to 1, every uid terminal. (d) a
              rolling swap of two replicas under a trickle of requests:
              every incarnation bumps, the READY replicas never fall below
              the floor of 1 (sampled every 20 ms), every trickled request
              completes. (e) after each part no block leaked and the shared
              namespace is empty; once every replica is closed the card's
              allocated memory is back within one replica's KV pool of its
              value before the phase. G, H, A and B over the int8 pool, C
              and D must launch; the first launch of each is replayed
              through its plain version. Prints the peak memory and the
              largest gap between a live replica's heartbeats against
              ``heartbeat_timeout_s`` (10 s), beside the card's name and
              power limit.

13. checkpoint -- engine checkpoints and the resilience layer. (a)
              ``llama3-1b`` at full width, 4 of its 16 layers (a depth
              cut for the script's time limit), with phase 5's config
              and batch (plus a WarmupLR schedule, so its state rides the
              tag): engine A (seed 0) takes 2 ``train_batch`` steps, saves
              synchronously (tag ``global_step2``: params, AdamW's moments
              and count, the scaler, the schedule, ``meta.json``) and takes
              2 more; engine B (seed 1, other weights) loads the tag: its
              whole state equals A's at the save bit for bit, and its 2
              steps give A's losses and leaves bit for bit; the gate is
              ``torch.equal`` because a second run of A's four steps, checked
              here too, gives the same bits.
              Prints save / load ms, bytes, GB/s and the temporary
              directory's filesystem and free bytes. (b) an async save under
              ``resilience.enabled`` with both ``async_save`` flags:
              ``save_checkpoint`` returns after the device-to-host copy (its
              ms printed), the next step runs while the commit thread writes
              (its ms beside the step before and phase 5's), ``latest``
              names the tag only once its manifest is there (polled every
              2 ms), the tag verifies, ``shutdown()`` joins the commit, at
              most two tags on disk (at 2 layers when the disk cannot hold
              a second full tag). (c) on tiny engines (width 256, bf16): a
              torn newest tag falls back to the previous one, keep-last-K
              collects, an injected ``io_error`` is retried, a
              ``nan_grads`` step is skipped with params and moments
              unchanged, SIGTERM gives a verified, loadable
              ``preempt_step2``, a heartbeat with a 5 s deadline reports no
              hang. (d) ``tools/crash_resume.py`` in two subprocesses: run
              0 tears the step-3 tag and hard-crashes in step 4 (exit 43),
              run 1 resumes from step 2, heals one NaN step and reaches step
              6. (e) ``init_inference(model, checkpoint=<(a)'s dir>)`` gives
              the greedy tokens of ``params=`` (A's params at the save) for
              two prompts of 16 new tokens; ``consolidate_to_fp32`` equals
              A's saved masters bit for bit; ``save_16bit_model`` writes the
              same names. D, E and F must launch; the first launch of each
              in (a) is replayed through its plain version. After the phase
              the card's allocated memory is back within 16 MB and every
              thread the phase started has ended.

14. train-features -- the rest of training on phase 5's ``llama3-1b``,
              config and batch. (a) one ``forward`` + ``backward`` under
              each remat policy: per-leaf grads within 1e-5 rel L2 of
              ``none``'s (bit-equality printed), kernel D launched L times
              for ``none`` and the policies that keep the attention output,
              2L for the rest, peak memory ``full`` <= ``attn_saveable`` <=
              ``none`` and ``offload_attn``'s below ``attn_saveable``'s
              (peak GB, host bytes and ms printed). (b) lamb, lion,
              adagrad, adafactor, rmsprop and muon, 3 ``train_batch`` steps
              each at the rate printed: finite losses, the last below the
              first; one update of the embedding, ``wq`` and ``ln1.scale``
              on the card against the CPU's within 1e-5 (muon 2e-2) rel L2
              of the displacement beyond fp32's rounding. (c) random-LTD
              (keep 1000 over layers [1, 15)): D's calls by rows, an LTD
              layer within 2e-2 of plain attention on the kept rows and
              its dropped rows equal to its input; PLD with 4 compiled
              tiers (D calls k a micro-batch) and gated (D calls = the
              host's kept layers); a curriculum 256 -> 2048 over 4 steps
              (D runs at each step's difficulty); ``loss_tiling`` 8 vs 1
              (loss 1e-3, grads 2e-2 rel L2, a lower peak). D, E and F's
              first launches at 1000 rows are replayed through their plain
              versions. Prints the phase's seconds.

15. moe-train -- MoE training on ``mixtral-8x7b`` at full width (D 4096,
              F 14336, 8 experts, top-2, H 32 / K 8, d 128, V 32000), cut
              to 2 of its 32 layers (fp32 masters, grads and AdamW moments
              of 32 layers would not fit the card), max_seq_len 2048, seed-0
              weights, ``TRAIN_CONFIG``'s AdamW and clipping at micro-batch
              2 x 2048 and GA 2: (a) the capacity dispatch (the preset's
              default) and (b) the grouped dispatch with the ragged
              product, each 3 ``train_batch`` steps and one
              ``fused_train_step`` on one fixed batch through
              ``initialize``: finite losses and grad norms, the last loss
              below the first, the trained model's aux loss > 0; the drop
              fraction (from an expert-load tracker over one forward),
              step ms, tokens/s, the model-FLOPs share on the active
              parameters (top-2 of 8 experts' MLPs, ``parallel/
              cost_model.py``'s count) and peak memory printed. (c) one
              MoE block at 1 x 2048 tokens in bf16: grouped ``ragged`` vs
              ``padded`` -- the same top-k indices, output and the grads of
              x, router, ``w_gate``, ``w_up``, ``w_down`` within rel L2
              2e-2 --, the capacity path at ``capacity_factor`` 8 (nothing
              drops) vs grouped within 2e-2, two ragged launches bit for
              bit; the 2-layer model's grads under remat ``full`` bit-equal
              to ``none``'s under both dispatches. (d) the tracker
              installed for the ``full`` grouped forward and backward:
              each layer reports once, 2048 x 2 routed pairs. D, E and F
              must launch; the first launch of each in (a) is replayed
              through its plain version.

16. moe-serve -- MoE serving on ``mixtral-8x7b`` at full width, cut to 8
              of its 32 layers (its bf16 experts are 2.82 GB a layer),
              seed-0 weights drawn on the card at the init scale, engines
              of max_seq_len 2048, 8 slots, block 128, phase 4's traffic,
              each engine freed before the next. The cross-path and
              cross-engine gates run under pinned routing (each row's
              experts fixed by its position, token and layer, the
              router's own gates as weights): a random router's near-tie
              top-2 choices flip under bf16 noise between batch layouts,
              and the w_down product's bits depend on an expert's row
              count below 256 (split-K); the free-running readings are
              printed beside. Each engine runs its traffic once untimed
              first. (a) the packed engine, grouped dispatch,
              ``ragged`` product, ``enable_metrics`` on: the 1100-token
              prompt's chunked logits vs a whole ``put`` of it and the
              129-token prompt's in the batch vs alone, rel L2 <= 2e-2,
              and a control whose chunk atoms drop their newest past
              token past twice that; every call's routed pairs (the
              expert-load tracker's reports) equal its real tokens x 2 x
              8 layers -- padding and idle lanes route nothing; the first
              launches of A-D replayed through their plain versions; a
              4-sequence decode ``put``'s device launches with the
              tracker on and off printed. (b) ``moe_kernel="padded"``:
              the 4-prompt ``put``'s logits vs (a)'s rel L2 <= 2e-2. (c)
              the capacity dispatch at the preset's factor (pairs at most
              real x 2 x 8, the drop fraction over real tokens printed),
              then at factor E (nothing drops: pairs exact, logits vs (a)
              <= 2e-2). (d) ``weight_dtype="int8", kv_dtype="int8"``: the
              expert leaves are int8 ``_q`` / bf16 ``_s`` pairs, never
              fused, each layer's stacks dequantize within 2e-2 of their
              max |w|; logits vs (a) within 0.6 of the max |logit| (a
              random router flips top-2 under int8 noise); first
              launches of G, H and A/B int8 replayed. (e) phase 7's
              2-layer cross-check on a seed-0 tree of 2 layers: the
              ``packed=False``, ``paged=False`` and v1 engines vs the
              packed engine within 2e-2, each control (newest column
              dropped) past twice that. Each engine prints prompt, mixed
              and decode tokens/s, its served tree's bytes, peak memory
              and the ragged product's host syncs a call (one a layer a
              forward). A-D, G, H, A/B int8 and I must launch.

17. offload -- ZeRO-Offload through ``initialize`` with
              ``zero_optimization.offload_optimizer`` (fp32 masters and Adam
              moments on the host, ``csrc/cpu_adam.cpp``'s OpenMP loop,
              page-locked masters and grad buffers, only the params back
              to the card), phase 5's ``TRAIN_CONFIG`` and batch: (a)
              llama3-1b at full width and depth -- the host Adam on flat
              fp32 buffers against its plain twin (rtol 1e-5, atol 1e-6;
              the OpenMP runtimes in the process and the loop's time at
              1, half and all threads printed), three steps
              against on-card AdamW from the same init (first loss
              bit-equal, the rest rtol 5e-3), every param on the card
              equal to its host master bit for bit, ``offload.aio.
              upload_overlap`` on and off bit-equal; each step's split
              (grad copy, Adam, upload; fwd+bwd) printed; (b)
              ``zenflow.overlap_step``: the first two losses within 1e-6,
              the next one the synchronous run's (shifted by one step,
              within 2e-2), and every loss from the second on equal, bit
              for bit, to a synchronous engine's whose step k takes step
              k-1's gradient (the overlapped host Adam reads a gradient
              one step stale; at phase 5's lr the plain synchronous run
              is 7.5% away by the third shifted step, so it is printed,
              not gated, past that); step times beside (a)'s; the OpenMP
              threads' cost to the forward and backward printed; and the
              top-k split (ratio 0.1,
              update interval 2: unselected columns of ``wo`` move only at
              the boundary step, selected ones every step); (c) at 2 of
              16 layers in the run's temporary directory, the NVMe tier
              serial and at depth 2 against the CPU tier, masters, m and
              v bit for bit after 2 steps, then the CPU-tier engine saved
              (``host_optimizer.npz`` beside ``state/``), one more step,
              and the same step of a fresh engine loaded from the tag,
              bit-equal; (d) llama3-8b at full width, 16 of 32 layers (a
              constant: the host holds 16 B a param), micro 2, three
              steps: finite losses, peak card memory below the card's;
              MemAvailable, host RSS, the split and on-card AdamW's 16 B a
              param printed. D, E and F must launch.

The last two lines of standard output are the ``kernels`` JSON line and the
result line ``{"ok": true, "device": {...}}``; the card's name and power
limit are printed before them. Imports neither JAX nor ``deepspeed_tpu``.
"""

from __future__ import annotations

import contextlib
import gc
import inspect
import itertools
import json
import os
import re
import resource
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
ATOL = RTOL = 2e-2             # normalised outputs, bf16 inputs
STAT_TOL = 1e-2                # m / lse
BWD_REL = 2e-2                 # dq/dk/dv and kernel I's output, per 64-row
                               # tile: max abs err / max |plain|
TILE = 64                      # rows of a kernel tile
CROSS_PATH_REL_L2 = 2e-2       # chunked vs whole-prompt last-token logits
GRAD_REL_L2 = 2e-2             # per-leaf grads, kernels vs plain attention
WEIGHT_REL_L2 = 2e-2           # G/H logits vs dense dequantized weights
DENSE_REL_L2 = 2e-2            # dense-tile / v1 logits vs the packed engine
DENSE_CONTROL_MARGIN = 2       # a control's reading / the gate, at least
# Phase 7 at full depth (attention_heavy bf16 weights): the packed engine's
# own bf16 noise is above DENSE_REL_L2, so each engine's limit lies between
# its sound reading and its control's (each row's newest column dropped);
# PERF.md's serve-dense entry gives both readings.
DENSE_FULL_REL_L2 = {"a": 0.15, "b": 0.45, "c": 0.3}
DENSE_FULL_CONTROL_MARGIN = 2
RMS_TOL = {"bfloat16": 1e-2, "float32": 1e-5}   # J, forward and backward
STREAM_REL = 1e-6              # K's sum vs its plain version
SERVE_KERNELS = ("paged_decode", "paged_past", "chunk_self", "flash_fwd")
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
PHASE_NOTES: dict = {}         # readings a later phase prints beside its own


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, flops_per_s: float = BF16_FLOPS_PER_S):
    """(ms, "bytes" | "operations"): the larger of bytes over the card's
    memory rate and operations over its peak rate for their type (bf16
    tensor-core products unless ``flops_per_s`` says otherwise)."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def close(name: str, got, want, atol: float, rtol: float) -> float:
    """assert_close in fp32; returns the max abs error."""
    import torch

    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol,
                               msg=lambda m: f"{name}: {m}")
    return float((got - want).abs().max()) if got.numel() else 0.0


def normalised(acc, l):
    """acc / l where l > 0 (rows with nothing visible compare as zero)."""
    return acc / l.clamp_min(1e-30)[..., None]


def close_tiles(name: str, got, want, rel: float = BWD_REL):
    """A gradient ``[B, T, heads, d]`` against its plain version, per
    ``TILE``-row tile of the sequence axis for each batch row and head:
    max |got - want| <= rel x max |want| over that tile (in fp32). Causal
    gradients shrink along the sequence, so one tensor-wide max would let
    late tiles off lightly. Returns ``(max abs error, max |want|, worst
    tile's max abs error / its max |want|)``."""
    import torch

    got, want = got.float(), want.float()
    B, T, H, d = want.shape
    pad = (0, 0, 0, 0, 0, -T % TILE)
    err = torch.nn.functional.pad((got - want).abs(), pad)
    ref = torch.nn.functional.pad(want.abs(), pad)
    e, s = (x.view(B, -1, TILE, H, d).amax(dim=(2, 4)) for x in (err, ref))
    bad = (e > rel * s).nonzero()
    if len(bad):
        b, t, h = bad[0].tolist()
        raise AssertionError(
            f"{name}: {len(bad)} tiles over the gate, first (batch {b}, rows "
            f"{t * TILE}.., head {h}): max abs err {float(e[b, t, h]):.3e} > "
            f"{rel} x tile max |plain| {float(s[b, t, h]):.3e}")
    worst = torch.where(s > 0, e / s.clamp_min(1e-30), 0.0).max()
    return float(err.max()), float(ref.max()), float(worst)


# ---------------------------------------------------------------------------
# phase 3: kernels at the main path's shapes
# ---------------------------------------------------------------------------

def make_pool(torch, g, L, nbp1, bs, KD, dev):
    return (torch.randn(L, nbp1, bs, KD, generator=g, device=dev)
            .to(torch.bfloat16))


def timings(kernel, args, wrapper, plain, make_args=None) -> dict:
    """``ms``: the kernel alone -- its launcher on arguments prepared once
    (CUDA events see only the card's time while launches queue faster than
    the kernel runs); ``wrapper_ms``: the whole wrapper (operand checks,
    metadata, allocation, launch); ``plain_ms``: the plain version. A kernel
    shorter than its launch (A, B, C, I's decode regime) gives
    ``make_args`` (its launcher's arguments, made on the
    current stream; :func:`on_stream`): ``ms`` is then its device time from
    a CUDA graph of launches (``decode_time.graph_ms``), and ``loop_ms``
    the loop of launches, which times the host."""
    r = dict(ms=time_ms(lambda: kernel.launch(*args)),
             wrapper_ms=time_ms(wrapper), plain_ms=time_ms(plain, iters=5))
    if make_args is not None:
        from deepspeed_tpu_torch.tools.decode_time import graph_ms

        r["loop_ms"] = r["ms"]
        r["ms"] = graph_ms(lambda: kernel.launch(*make_args()))
    return r


def on_stream(args):
    """A launcher's arguments (its stream last, as every launcher of the
    port takes it) with the current stream: a CUDA graph captures only
    launches on its own stream."""
    import torch

    return (*args[:-1], torch.cuda.current_stream().cuda_stream)


def build_report(build, lib: str, kernel: str, pattern: str, variants,
                 unit: str, smem_symbol: str) -> None:
    """A kernel's ptxas report from the log of the build that made its
    library -- registers, stack frame and spill bytes per instantiation
    (``pattern`` captures its template argument from the mangled name, or
    a tuple of them) --
    beside the dynamic shared memory it launches with (``smem_symbol``, one
    int per variant). Spilled bytes fail the run."""
    import ctypes

    path = build.build_log(lib)
    report = {}
    for name, r in build.ptxas_report(path.read_text()).items():
        m = re.search(pattern, name)
        if m:
            key = tuple(int(v) for v in m.groups())
            report[key[0] if len(key) == 1 else key] = r
    smem = (ctypes.c_int * len(variants)).in_dll(build.library(lib),
                                                 smem_symbol)
    for i, v in enumerate(variants):
        r = report.get(v)
        if r is None or "spill_stores" not in r:
            raise AssertionError(f"kernel {kernel} at {unit}={v}: no ptxas "
                                 f"report in {path}")
        log(f"kernel {kernel} ptxas ({unit}={v}): {r.get('registers')} "
            f"registers, {r['stack']} bytes stack frame, "
            f"{r['spill_stores']} bytes spill stores, {r['spill_loads']} "
            f"bytes spill loads; {smem[i]} bytes of dynamic shared memory")
        if r["spill_stores"] or r["spill_loads"]:
            raise AssertionError(f"kernel {kernel} at {unit}={v} spills "
                                 f"registers")


# Head dims the card's attention kernels are built for (the port's
# ``ops.CARD_HEAD_DIMS``; a CPU test holds the two equal)
CARD_HEAD_DIMS = (64, 96, 128, 256)

# (library, kernel, pattern of its mangled name, variants, unit, shared
# memory symbol): kernels D, E and F, A's and B's pool modes (A's int4:
# paired kv heads, then one nibble), C and I's two regimes per head dim,
# G/H's decode kernel (B <= 16) per weight width and row tile (8 or 16
# rows), and G/H's multi-row kernel (16 < B <= 256) per weight width
PTXAS_REPORTS = (
    ("paged_decode", "paged_decode",
     r"paged_decode_kernelILi16ELb0ELi(\d+)E", CARD_HEAD_DIMS, "d",
     "dst_paged_decode_smem_bytes"),
    ("paged_decode", "paged_decode_int8",
     r"paged_decode_kernelILi8ELb0ELi(\d+)E", CARD_HEAD_DIMS, "d",
     "dst_paged_decode_int8_smem_bytes"),
    ("paged_decode", "paged_decode_int4",
     r"paged_decode_kernelILi4ELb1ELi(\d+)E", CARD_HEAD_DIMS, "d",
     "dst_paged_decode_int4_smem_bytes"),
    ("paged_decode", "paged_decode_int4 one-nibble",
     r"paged_decode_kernelILi4ELb0ELi(\d+)E", CARD_HEAD_DIMS, "d",
     "dst_paged_decode_int4_smem_bytes"),
    ("paged_attention", "paged_past", r"paged_past_kernelILi16ELi(\d+)E",
     CARD_HEAD_DIMS, "d", "dst_paged_past_smem_bytes"),
    ("paged_attention", "paged_past_int8", r"paged_past_kernelILi8ELi(\d+)E",
     CARD_HEAD_DIMS, "d", "dst_paged_past_int8_smem_bytes"),
    ("paged_attention", "paged_past_int4", r"paged_past_kernelILi4ELi(\d+)E",
     CARD_HEAD_DIMS, "d", "dst_paged_past_int4_smem_bytes"),
    ("flash_attention", "chunk_self", r"chunk_self_kernelILi(\d+)E",
     CARD_HEAD_DIMS, "d", "dst_chunk_self_smem_bytes"),
    ("flash_forward", "flash_fwd", r"flash_fwd_kernelILi(\d+)E",
     CARD_HEAD_DIMS, "d", "dst_flash_fwd_smem_bytes"),
    ("flash_backward", "flash_bwd_dq", r"flash_bwd_dq_kernelILi(\d+)E",
     CARD_HEAD_DIMS, "d", "dst_flash_bwd_dq_smem_bytes"),
    ("flash_backward", "flash_bwd_dkv", r"flash_bwd_dkv_kernelILi(\d+)E",
     CARD_HEAD_DIMS, "d", "dst_flash_bwd_dkv_smem_bytes"),
    ("paged_tile", "paged_tile decode", r"paged_tile_decode_kernelILi(\d+)E",
     CARD_HEAD_DIMS, "d", "dst_paged_tile_decode_smem_bytes"),
    ("paged_tile", "paged_tile flash", r"paged_tile_kernelILi(\d+)E",
     CARD_HEAD_DIMS, "d", "dst_paged_tile_smem_bytes"),
    ("quant_matmul", "qmm_rows", r"qmm_rows_kernelILi(\d+)ELi(\d+)E",
     ((4, 1), (4, 2), (8, 1), (8, 2)), "(bits, n8 tiles)",
     "dst_qmm_rows_smem_bytes"),
    ("quant_matmul", "qmm_tile", r"qmm_tile_kernelILi(\d+)E", (4, 8),
     "bits", "dst_qmm_tile_smem_bytes"),
)


def build_reports(build) -> None:
    for row in PTXAS_REPORTS:
        build_report(build, *row)


def in_turns(kernel, args, library) -> dict:
    """A kernel beside one library call computing the same function, timed
    in turns in this call (library, kernel, kernel, library): ``ms`` and
    ``library_ms`` the mean of each pair, ``turns`` the four readings."""
    return in_turns_fn(lambda: kernel.launch(*args), library)


def in_turns_fn(fn, library) -> dict:
    """:func:`in_turns` for any call ``fn``, such as two kernels in turn."""
    readings = (time_ms(library), time_ms(fn), time_ms(fn), time_ms(library))
    return dict(ms=(readings[1] + readings[2]) / 2,
                library_ms=(readings[0] + readings[3]) / 2, turns=readings)


def flash_fwd_checks(torch, fa, KERNELS, q, k, v, tag: str) -> dict:
    """Kernel D causal on ``q`` [B,T,H,d], ``k``/``v`` [B,T,K,d]: out per
    64-row tile, batch row and head (:func:`close_tiles`), lse at
    ``STAT_TOL``; timed in turns with SDPA, beside its wrapper, its plain
    version and its bound."""
    B, T, H, d = q.shape
    out, lse = fa.flash_attention_lse(q, k, v, causal=True)
    pout, plse = fa.plain_flash_forward(q, k, v, causal=True)
    tiles = {"out": close_tiles(f"D out ({tag})", out, pout)}
    close(f"D lse ({tag})", lse, plse, STAT_TOL, STAT_TOL)
    del pout, plse
    nbytes = ((q.numel() + k.numel() + v.numel() + out.numel()) * 2
              + lse.numel() * 4)
    flops = 4 * B * H * d * (T * (T + 1) // 2)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    args, _ = fa.flash_kernel_args(q, k, v, causal=True)
    return dict(
        err=tiles["out"][0], tiles=tiles, bound=bound(nbytes, flops),
        **in_turns(KERNELS["flash_fwd"], args,
                   lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)),
        wrapper_ms=time_ms(lambda: fa.flash_attention_lse(q, k, v,
                                                          causal=True)),
        plain_ms=time_ms(lambda: fa.plain_flash_forward(q, k, v,
                                                        causal=True),
                         iters=5),
        shape=f"B={B} T=S={T} H={H} K={k.shape[2]} d={d}, causal")


def kernel_checks(torch, pa, fa, KERNELS, H=32, K=8, d=128, suffix="",
                  seed=1234, one_launch=True):
    """Kernels A-D and A/B's int modes at the serve phase's shapes: H query
    heads over K kv heads of head dim d (Llama-3-8B's by default); the rows'
    keys end in ``suffix``. B (each pool mode) and C: two launches give the
    same bits, and a call is one launch on the card (``launches_per_call``;
    ``one_launch`` False records the count without the gate)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    bs = 128
    max_seq, n_slots = 2048, 8
    nb_max = max_seq // bs
    nbp1 = n_slots * nb_max + 1
    L = 2                      # pool depth: the work does not depend on L
    KD = K * d
    kpool, vpool = (make_pool(torch, g, L, nbp1, bs, KD, dev) for _ in "kv")
    perm = torch.randperm(nbp1 - 1, generator=g, device=dev).to(torch.int32)
    bt = perm.reshape(n_slots, nb_max).contiguous()
    layer = 1
    rows = {}

    # ---- A: 8 decode atoms at the serve phase's lengths
    pos0 = torch.tensor([38, 129, 130, 701, 301, 1101, 0, 0],
                        dtype=torch.int32, device=dev)
    slot = torch.arange(8, dtype=torch.int32, device=dev)
    q = torch.randn(8, H, d, generator=g, device=dev).to(torch.bfloat16)
    acc, m, l = pa.decode_pool_partials(q, kpool, vpool, layer, bt, slot,
                                        pos0)
    pacc, pm, pl = pa.plain_decode_partials(q, kpool, vpool, layer, bt, slot,
                                            pos0)
    live = pos0 > 0
    err = close("A out", normalised(acc, l)[live], normalised(pacc, pl)[live],
                ATOL, RTOL)
    close("A m", m[live], pm[live], STAT_TOL, STAT_TOL)
    if not (torch.all(l[~live] == 0) and torch.all(acc[~live] == 0)):
        raise AssertionError("A: atoms with pos0 == 0 must give l = acc = 0")
    cols = int(pos0.sum())
    nbytes = cols * KD * 2 * 2 + q.numel() * 2 + acc.numel() * 4 + 2 * m.numel() * 4
    flops = 4 * H * d * cols
    def a_args():
        return pa.decode_kernel_args(q, kpool, vpool, layer, bt, slot,
                                     pos0)[0]
    rows[f"paged_decode{suffix}"] = dict(
        err=err, bound=bound(nbytes, flops), library_ms=None,
        **timings(KERNELS["paged_decode"], a_args(),
                  lambda: pa.decode_pool_partials(q, kpool, vpool, layer, bt,
                                                  slot, pos0),
                  lambda: pa.plain_decode_partials(q, kpool, vpool, layer, bt,
                                                   slot, pos0), a_args),
        shape=f"A=8 atoms, H={H} K={K} d={d} bs=128, pos0 "
              + ",".join(str(int(p)) for p in pos0))

    # ---- B: two 256-token chunk atoms with a pooled past
    tq = 256
    pos0b = torch.tensor([256, 768], dtype=torch.int32, device=dev)
    slotb = torch.tensor([4, 5], dtype=torch.int32, device=dev)
    qb = torch.randn(2 * tq, H, d, generator=g, device=dev).to(torch.bfloat16)
    accb, mb, lb = pa.past_partials(qb, kpool, vpool, layer, bt, slotb, pos0b,
                                    tq)
    paccb, pmb, plb = pa.plain_past_partials(qb, kpool, vpool, layer, bt,
                                             slotb, pos0b, tq)
    err = close("B out", normalised(accb, lb), normalised(paccb, plb),
                ATOL, RTOL)
    close("B m", mb, pmb, STAT_TOL, STAT_TOL)
    launches = one_call(torch, f"B{suffix}", lambda: pa.past_partials(
        qb, kpool, vpool, layer, bt, slotb, pos0b, tq), one_launch)
    cols = int(pos0b.sum())
    nbytes = (cols * KD * 2 * 2 + qb.numel() * 2 + accb.numel() * 4
              + 2 * mb.numel() * 4)
    flops = 4 * tq * H * d * cols
    args, _ = pa.past_kernel_args(qb, kpool, vpool, layer, bt, slotb, pos0b,
                                  tq)
    rows[f"paged_past{suffix}"] = dict(
        err=err, bound=bound(nbytes, flops), library_ms=None,
        launches_per_call=launches,
        **timings(KERNELS["paged_past"], args,
                  lambda: pa.past_partials(qb, kpool, vpool, layer, bt,
                                           slotb, pos0b, tq),
                  lambda: pa.plain_past_partials(qb, kpool, vpool, layer, bt,
                                                 slotb, pos0b, tq),
                  lambda: on_stream(args)),
        shape=f"2 atoms x tq=256, H={H} K={K} d={d} bs=128, pos0 256,768")

    # ---- C: the same atoms' self flash, seeded from B's (plain) partials
    alen = torch.tensor([256, 200], dtype=torch.int32, device=dev)
    ks = torch.randn(2 * tq, K, d, generator=g, device=dev).to(torch.bfloat16)
    vs = torch.randn(2 * tq, K, d, generator=g, device=dev).to(torch.bfloat16)
    seed = (paccb, pmb, plb)
    outc = pa.self_attention(qb, ks, vs, alen, tq, seed)
    poutc = pa.plain_self_attention(qb, ks, vs, alen, tq, seed)
    err = close("C out", outc, poutc, ATOL, RTOL)
    launches = one_call(torch, f"C{suffix}", lambda: pa.self_attention(
        qb, ks, vs, alen, tq, seed), one_launch)
    pairs = sum(n * (n + 1) // 2 for n in alen.tolist())
    nbytes = ((qb.numel() + ks.numel() + vs.numel() + outc.numel()) * 2
              + (paccb.numel() + 2 * pmb.numel()) * 4)
    flops = 4 * H * d * pairs
    args, _ = pa.self_kernel_args(qb, ks, vs, alen, tq, seed)
    rows[f"chunk_self{suffix}"] = dict(
        err=err, bound=bound(nbytes, flops), library_ms=None,
        launches_per_call=launches,
        **timings(KERNELS["chunk_self"], args,
                  lambda: pa.self_attention(qb, ks, vs, alen, tq, seed),
                  lambda: pa.plain_self_attention(qb, ks, vs, alen, tq,
                                                  seed),
                  lambda: on_stream(args)),
        shape=f"2 atoms x tq=256 (alen 256,200), H={H} K={K} d={d}, "
              f"seeded")

    # ---- D: whole-prompt prefill of 4 prompts padded to T=1024
    B, T = 4, 1024
    qd = torch.randn(B, T, H, d, generator=g, device=dev).to(torch.bfloat16)
    kd = torch.randn(B, T, K, d, generator=g, device=dev).to(torch.bfloat16)
    vd = torch.randn(B, T, K, d, generator=g, device=dev).to(torch.bfloat16)
    rows[f"flash_fwd{suffix}"] = flash_fwd_checks(
        torch, fa, KERNELS, qd, kd, vd, f"serve shape{suffix}")
    rows.update(quant_pool_checks(
        torch, pa, KERNELS, kpool, vpool, layer, bt,
        decode=(q, slot, pos0), past=(qb, slotb, pos0b, tq), suffix=suffix,
        one_launch=one_launch))
    torch.cuda.synchronize()
    for name, r in rows.items():
        loop = (f", a loop of launches {r['loop_ms']:.4f} ms"
                if "loop_ms" in r else "")
        log(f"kernel {name}: max_abs_err {r['err']:.3e}, kernel "
            f"{r['ms']:.4f} ms{loop} (wrapper {r['wrapper_ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms by "
            f"{r['bound'][1]}, library {r['library_ms']}) [{r['shape']}]")
        log_tiles(name, r)
        log_turns(name, r)
    return rows


def quantize_pool(torch, pa, pool_k, pool_v, bits):
    """The bf16 pools' rows written through ``packed_kv_append_quant`` into
    int8 / int4 pools (every physical row, scratch block included), with
    their per-token scales."""
    L, nbp1, bs, KD = pool_k.shape
    dev = pool_k.device
    lanes = KD // 2 if bits == 4 else KD
    out = [torch.zeros(L, nbp1, bs, lanes, dtype=torch.int8, device=dev)
           for _ in "kv"]
    scale = torch.zeros(L, nbp1, 1, 2 * bs, device=dev)
    bt_all = torch.arange(nbp1, dtype=torch.int32, device=dev)[None]
    slot = torch.zeros(nbp1 * bs, dtype=torch.int32, device=dev)
    pos = torch.arange(nbp1 * bs, dtype=torch.int32, device=dev)
    for which, (src, dst) in enumerate(zip((pool_k, pool_v), out)):
        pa.packed_kv_append_quant(dst, scale, src.reshape(L, nbp1 * bs, KD),
                                  bt_all, slot, pos, which, bits=bits)
    return out[0], out[1], scale


def quant_pool_checks(torch, pa, KERNELS, kpool, vpool, layer, bt, decode,
                      past, suffix="", one_launch=True):
    """The int8 / int4 modes of A and B on the bf16 checks' atoms, over the
    same pools quantized by the port's append (rows' keys end in
    ``suffix``); B's as :func:`kernel_checks` holds B's bf16 mode."""
    rows = {}
    q, slot, pos0 = decode
    qb, slotb, pos0b, tq = past
    H, d = q.shape[1:]
    KD = kpool.shape[3]
    for bits in (8, 4):
        kq, vq, sc = quantize_pool(torch, pa, kpool, vpool, bits)
        kw = dict(kv_scale=sc, kv_bits=bits)
        name = pa.kernel_name("paged_decode", sc, bits)
        acc, m, l = pa.decode_pool_partials(q, kq, vq, layer, bt, slot, pos0,
                                            **kw)
        pacc, pm, pl = pa.plain_decode_partials(q, kq, vq, layer, bt, slot,
                                                pos0, **kw)
        live = pos0 > 0
        err = close(f"{name} out", normalised(acc, l)[live],
                    normalised(pacc, pl)[live], ATOL, RTOL)
        close(f"{name} m", m[live], pm[live], STAT_TOL, STAT_TOL)
        if not (torch.all(l[~live] == 0) and torch.all(acc[~live] == 0)):
            raise AssertionError(f"{name}: atoms with pos0 == 0 must give "
                                 f"l = acc = 0")
        cols = int(pos0.sum())
        pool_bytes = cols * (KD * bits // 8 + 4) * 2      # rows + scales
        nbytes = pool_bytes + q.numel() * 2 + acc.numel() * 4 \
            + 2 * m.numel() * 4
        def a_args():
            return pa.decode_kernel_args(q, kq, vq, layer, bt, slot, pos0,
                                         **kw)[0]
        rows[name + suffix] = dict(
            err=err, bound=bound(nbytes, 4 * H * d * cols), library_ms=None,
            **timings(KERNELS[name], a_args(),
                      lambda: pa.decode_pool_partials(q, kq, vq, layer, bt,
                                                      slot, pos0, **kw),
                      lambda: pa.plain_decode_partials(q, kq, vq, layer, bt,
                                                       slot, pos0, **kw),
                      a_args),
            shape=f"int{bits} pool, the bf16 A atoms")

        name = pa.kernel_name("paged_past", sc, bits)
        accb, mb, lb = pa.past_partials(qb, kq, vq, layer, bt, slotb, pos0b,
                                        tq, **kw)
        paccb, pmb, plb = pa.plain_past_partials(qb, kq, vq, layer, bt,
                                                 slotb, pos0b, tq, **kw)
        err = close(f"{name} out", normalised(accb, lb),
                    normalised(paccb, plb), ATOL, RTOL)
        close(f"{name} m", mb, pmb, STAT_TOL, STAT_TOL)
        launches = one_call(torch, f"{name}{suffix}", lambda: pa.past_partials(
            qb, kq, vq, layer, bt, slotb, pos0b, tq, **kw), one_launch)
        cols = int(pos0b.sum())
        nbytes = (cols * (KD * bits // 8 + 4) * 2 + qb.numel() * 2
                  + accb.numel() * 4 + 2 * mb.numel() * 4)
        args, _ = pa.past_kernel_args(qb, kq, vq, layer, bt, slotb, pos0b,
                                      tq, **kw)
        rows[name + suffix] = dict(
            err=err, bound=bound(nbytes, 4 * tq * H * d * cols),
            library_ms=None, launches_per_call=launches,
            **timings(KERNELS[name], args,
                      lambda: pa.past_partials(qb, kq, vq, layer, bt, slotb,
                                               pos0b, tq, **kw),
                      lambda: pa.plain_past_partials(qb, kq, vq, layer, bt,
                                                     slotb, pos0b, tq, **kw),
                      lambda: on_stream(args)),
            shape=f"int{bits} pool, the bf16 B atoms")
        del kq, vq, sc
    return rows


def one_call(torch, tag: str, call, one_launch: bool = True) -> int:
    """``call`` twice on the same inputs gives the same bits, and one call
    is one launch on the card (:func:`device_launches`; ``one_launch``
    False only counts). Returns the count."""
    first, second = call(), call()
    if not isinstance(first, tuple):
        first, second = (first,), (second,)
    if not all(torch.equal(x, y) for x, y in zip(first, second)):
        raise AssertionError(f"{tag}: two launches on the same inputs differ")
    launches = device_launches(torch, call)
    if one_launch and launches != 1:
        raise AssertionError(f"{tag}: {launches} launches on the card for "
                             f"one call, not 1")
    return launches


def chunked_equals_whole(torch, pa, fa, H=32, K=8, d=128, T=1024, tq=256,
                         bs=128, seed=5678) -> list:
    """A prompt of T tokens whose first P tokens' K/V sit in a bf16 pool
    behind a shuffled block table (P = 256, 512, 768): kernel B over the
    next tq rows at pos0 = P, then kernel C seeded from B's partials, must
    give kernel D's bits for those rows of the whole prompt. The serve
    phase's chunked-vs-whole gate rests on it. Returns the P checked."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(1, T, H, d, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(1, T, K, d, generator=g, device=dev).bfloat16()
            for _ in "kv")
    want, _ = fa.flash_forward(q, k, v, causal=True)
    nb_max, nbp1 = T // bs, 2 * T // bs + 1
    bt = torch.randperm(nbp1 - 1, generator=g, device=dev)[:nb_max]
    bt = bt.to(torch.int32).reshape(1, nb_max).contiguous()
    pools = [torch.zeros(1, nbp1, bs, K * d, dtype=torch.bfloat16,
                         device=dev) for _ in "kv"]
    for pool, x in zip(pools, (k, v)):
        pool[0, bt[0].long()] = x[0].reshape(nb_max, bs, K * d)
    slot = torch.zeros(1, dtype=torch.int32, device=dev)
    alen = torch.full((1,), tq, dtype=torch.int32, device=dev)
    checked = []
    for P in range(tq, T, tq):
        rows = slice(P, P + tq)
        pos0 = torch.full((1,), P, dtype=torch.int32, device=dev)
        qc, kc, vc = (x[0, rows].contiguous() for x in (q, k, v))
        seed_p = pa.past_partials(qc, *pools, 0, bt, slot, pos0, tq)
        out = pa.self_attention(qc, kc, vc, alen, tq, seed_p)
        if not torch.equal(out, want[0, rows]):
            diff = float((out.float() - want[0, rows].float()).abs().max())
            raise AssertionError(f"kernels B then C at pos0 = {P} differ "
                                 f"from kernel D's rows (max abs {diff:.3e})")
        checked.append(P)
    log(f"kernels B then C vs kernel D (H={H} K={K} d={d}, a {T}-token "
        f"prompt chunked at {checked} over a shuffled bf16 pool): bit for "
        f"bit")
    return checked


def device_launches(torch, fn, traces: int = 8) -> int:
    """Kernels the card ran for one call of ``fn``, counted by
    ``torch.profiler`` (a ``Kernel`` record counts wrapper calls only).

    CUPTI now and then hands the profiler no records for a short trace (a
    one-launch call once read 0 launches; once three traces in a row lost
    their records). So a control kernel (``torch.cuda._sleep``'s
    ``spin_kernel``, ~0.1 ms) runs just before and just after the call,
    and only a trace that shows both is read; another is taken otherwise,
    half a second later, and after ``traces`` incomplete ones the run
    fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for n in range(1, traces + 1):
        torch.cuda.synchronize()
        if n > 1:
            time.sleep(0.5)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(200_000)
            fn()
            torch.cuda._sleep(200_000)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) == DeviceType.CUDA]
        control = sum(e.count for e in events if "spin_kernel" in e.key)
        if control == 2:
            return sum(e.count for e in events) - control
        log(f"device_launches: trace {n} of {traces} shows {control} of the "
            f"2 control kernels; not read")
    raise AssertionError(f"the profiler missed the control kernels in "
                         f"{traces} traces: no launch count")


def qmm_row(torch, qm, KERNELS, x, packed, scales, bits, layer, shape,
            dense, one_launch=True, cycle=4):
    """G (``layer`` None) or H on one product, held against the plain
    version -- per 64-row tile as well when there are more rows than one
    tile (``close_tiles``), and bit for bit against a second launch -- and
    timed beside cuBLAS on the dense bf16 weights ``dense`` (one matrix a
    layer, cycled). H's launches cycle over ``cycle`` layers of the stack
    from layer ``layer``. At B <= 16 the decode kernel is shorter than its
    launch from Python: its time (and cuBLAS's) comes from a CUDA graph of
    launches (``decode_time.graph_ms``; ``loop_ms`` is the loop of
    launches), and the call must be one launch on the card
    (``one_launch``; ``launches_per_call`` counts it)."""
    from deepspeed_tpu_torch.tools.decode_time import graph_ms

    name = "qmm" if layer is None else "qmm_stacked"
    out = qm.quantized_matmul(x, packed, scales, bits=bits, layer=layer)
    ref = qm.plain_quantized_matmul(x, packed, scales, bits, layer)
    err = close(f"{name} int{bits} {shape}", out, ref, ATOL, RTOL)
    B, D = x.shape
    G, F = scales.shape[-2:]
    extra = {}
    if B > TILE:
        extra["tiles"] = {"out": close_tiles(
            f"{name} int{bits} {shape}", out.view(1, B, 1, F),
            ref.view(1, B, 1, F))}
    again = qm.quantized_matmul(x, packed, scales, bits=bits, layer=layer)
    if not torch.equal(again, out):
        raise AssertionError(f"{name} int{bits} {shape}: two launches on the "
                             f"same inputs differ")
    nbytes = B * D * 2 + D * F * bits // 8 + G * F * 2 + B * F * 2
    kern = KERNELS[name]
    layers = [None] if layer is None else [
        (layer + i) % packed.shape[0] for i in range(cycle)]
    lay, mats = itertools.cycle(layers), itertools.cycle(dense)
    args = [qm.qmm_kernel_args(x, packed, scales, bits, layer=i)[0]
            for i in layers]
    cyc = itertools.cycle(args)
    n = 5 * len(layers)
    t = dict(ms=time_ms(lambda: kern.launch(*next(cyc)), iters=n),
             wrapper_ms=time_ms(lambda: qm.quantized_matmul(
                 x, packed, scales, bits=bits, layer=next(lay)), iters=n),
             plain_ms=time_ms(lambda: qm.plain_quantized_matmul(
                 x, packed, scales, bits, layer), iters=5))
    if B <= 16:
        t["loop_ms"] = t["ms"]
        t["ms"] = graph_ms(lambda: kern.launch(*qm.qmm_kernel_args(
            x, packed, scales, bits, layer=next(lay))[0]))
        lib = graph_ms(lambda: torch.matmul(x, next(mats)))
        extra["launches_per_call"] = device_launches(
            torch, lambda: qm.quantized_matmul(x, packed, scales, bits=bits,
                                               layer=layer))
        if one_launch and extra["launches_per_call"] != 1:
            raise AssertionError(
                f"{name} int{bits} {shape}: {extra['launches_per_call']} "
                f"launches on the card for one call, not 1")
    else:
        lib = time_ms(lambda: torch.matmul(x, next(mats)))
    return dict(err=err, bound=bound(nbytes, 2.0 * B * D * F),
                library_ms=lib, library="torch.matmul (cuBLAS), dense bf16",
                shape=shape, splits=qm.qmm_splits(B, F, G), **extra, **t)


# llama3-8b's four quantized layer products (D, F): H runs each at B=256 in
# the serve-quant phase's 256-row chunk steps and at B=6 in its decode steps
QMM_LEAVES = (("w_gateup", 4096, 28672), ("wqkv", 4096, 6144),
              ("wo", 4096, 4096), ("w_down", 14336, 4096))
# phase 3's rows of each product: every decode product at B=6, w_gateup
# also at B=1 and B=16 (the decode kernel's two row tiles' ends), and every
# product at B=256 (the multi-row kernel)
QMM_ROWS = {"w_gateup": (6, 1, 16, 256), "wqkv": (6, 256), "wo": (6, 256),
            "w_down": (6, 256)}
L2_BYTES = 50e6                # H100 L2 cache
COLD_BYTES = 3 * L2_BYTES      # what a cycle of weights spans at least


def qmm_checks(torch, qm, KERNELS, one_launch=True):
    """G on the llama3-8b head (B=6, D=4096, F=128256); H on each layer
    product of a stack at layer 2 at the rows of ``QMM_ROWS``; int4 and
    int8, from seeded random weights quantized by the port. The decode rows
    (B <= 16) cycle over enough layers, and cuBLAS over enough dense copies,
    that each launch reads its weights from HBM, as in serving (the stack
    spans ``COLD_BYTES``, three times L2); the B=256 rows cycle over four
    layers."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5678)
    D, V = 4096, 128256
    xs = {B: torch.randn(B, D, generator=g, device=dev).bfloat16()
          for B in (1, 6, 16, 256)}
    rows = {}
    head = torch.randn(D, V, generator=g, device=dev) / D ** 0.5
    for bits in (4, 8):
        p, sc = qm.quantize_matmul_weight(head, bits=bits)
        sc = sc.bfloat16()
        dense = [qm.dequantize_matmul_weight(p, sc, bits, D)]
        rows[f"qmm/int{bits}"] = qmm_row(
            torch, qm, KERNELS, xs[6], p, sc, bits, None,
            f"llama3-8b head: B=6 D={D} F={V}, int{bits}", dense, one_launch)
        del p, sc, dense
    del head
    for bits in (4, 8):
        for leaf, DL, F in QMM_LEAVES:
            L = max(4, -(-int(COLD_BYTES) // (DL * F * bits // 8)))
            ps, ss = [], []
            for _ in range(L):
                w = torch.randn(DL, F, generator=g, device=dev) / DL ** 0.5
                p, sc = qm.quantize_matmul_weight(w, bits=bits)
                ps.append(p)
                ss.append(sc.bfloat16())
            stack = (torch.stack(ps), torch.stack(ss))
            del ps, ss, w
            nd = -(-int(COLD_BYTES) // (DL * F * 2))
            dense = [qm.dequantize_matmul_weight(stack[0][(2 + i) % L],
                                                 stack[1][(2 + i) % L],
                                                 bits, DL)
                     for i in range(nd)]
            for B in QMM_ROWS[leaf]:
                x = (xs[B] if DL == D else
                     torch.randn(B, DL, generator=g, device=dev).bfloat16())
                key = f"qmm_stacked/int{bits}/B{B}"
                rows[key if leaf == "w_gateup" else f"{key}/{leaf}"] = \
                    qmm_row(torch, qm, KERNELS, x, *stack, bits, 2,
                            f"{leaf}, layer 2 of {L if B <= 16 else 4}: "
                            f"B={B} D={DL} F={F}, int{bits}",
                            dense if B <= 16 else dense[:1], one_launch,
                            cycle=L if B <= 16 else 4)
            del stack, dense
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    for name, r in rows.items():
        tiles = (f", worst 64-row tile err / tile max |plain| "
                 f"{r['tiles']['out'][2]:.3e} (gate {BWD_REL})"
                 if "tiles" in r else "")
        graph = (f", a graph of launches (loop {r['loop_ms']:.4f} ms), "
                 f"{r['launches_per_call']} launch(es) a call"
                 if "loop_ms" in r else "")
        log(f"kernel {name}: max_abs_err {r['err']:.3e}{tiles}, kernel "
            f"{r['ms']:.4f} ms{graph} (wrapper {r['wrapper_ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms by "
            f"{r['bound'][1]}, library {r['library_ms']:.4f} ms cuBLAS; "
            f"{r['splits']} split(s), kernel / cuBLAS "
            f"{r['ms'] / r['library_ms']:.2f}, kernel / bound "
            f"{r['ms'] / r['bound'][0]:.2f}) [{r['shape']}]")
    return rows


# phase 3's head-dim rows: phi3-mini's heads (H = K = 32, d = 96) and
# pythia-1b's (H = K = 8, d = 256), the rows' keys ending in /d96, /d256
HEAD_DIM_SHAPES = (("/d96", 32, 32, 96), ("/d256", 8, 8, 256))


def backward_checks(torch, fa, KERNELS):
    """Kernel D at the training shape, and kernels E and F at the training
    shape (d = 64), at d = 128 and at the head-dim shapes (d = 96, 256; B=1,
    T = 2048), against their plain versions."""
    from deepspeed_tpu_torch.tools.flash_bwd_time import sdpa_backward
    from deepspeed_tpu_torch.tools.train_profile import TRAIN_SEQ

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)
    rows = {}
    shapes = [("train", (4, TRAIN_SEQ, 32, 8, 64)),
              ("d128", (1, TRAIN_SEQ, 32, 8, 128))]
    shapes += [(sfx[1:], (1, TRAIN_SEQ, H, K, d))
               for sfx, H, K, d in HEAD_DIM_SHAPES]
    for tag, (B, T, H, K, d) in shapes:
        def rnd(*shape):
            return torch.randn(*shape, generator=g, device=dev).bfloat16()

        q, do, k, v = rnd(B, T, H, d), rnd(B, T, H, d), rnd(B, T, K, d), \
            rnd(B, T, K, d)
        shape = f"B={B} T=S={T} H={H} K={K} d={d}, causal"
        pairs = B * H * T * (T + 1) // 2          # live (row, col) per head
        if tag == "train":
            rows["flash_fwd/train"] = flash_fwd_checks(
                torch, fa, KERNELS, q, k, v, "train shape")
        out, lse = fa.flash_forward(q, k, v, causal=True)
        delta = fa.flash_delta(out, do)
        ins = (q, k, v, do, lse, delta)
        dq = fa.flash_bwd_dq(*ins, causal=True)
        dk, dv = fa.flash_bwd_dkv(*ins, causal=True)
        tiles_dq = {"dq": close_tiles(f"E dq ({tag})", dq,
                                      fa.plain_flash_bwd_dq(*ins,
                                                            causal=True))}
        pdk, pdv = fa.plain_flash_bwd_dkv(*ins, causal=True)
        tiles_dkv = {"dk": close_tiles(f"F dk ({tag})", dk, pdk),
                     "dv": close_tiles(f"F dv ({tag})", dv, pdv)}
        del pdk, pdv
        sdpa_bwd, backend = sdpa_backward(q, k, v, do)
        in_bytes = (q.numel() + k.numel() + v.numel() + do.numel()) * 2 \
            + (lse.numel() + delta.numel()) * 4
        args_e, _ = fa.flash_bwd_kernel_args(*ins, part="dq", causal=True)
        args_f, _ = fa.flash_bwd_kernel_args(*ins, part="dkv", causal=True)
        # E then F, the whole backward, in turns with SDPA's whole backward
        pair = in_turns_fn(
            lambda: (KERNELS["flash_bwd_dq"].launch(*args_e),
                     KERNELS["flash_bwd_dkv"].launch(*args_f)), sdpa_bwd)
        lib = pair["library_ms"]
        e_plus_f = dict(ms=pair["ms"], library_ms=lib,
                        ratio=pair["ms"] / lib)
        log(f"kernels E+F ({tag}) in turns with one SDPA backward "
            f"({backend}): library {pair['turns'][0]:.4f}, E+F "
            f"{pair['turns'][1]:.4f}, E+F {pair['turns'][2]:.4f}, library "
            f"{pair['turns'][3]:.4f} ms; (E+F) / SDPA backward "
            f"{e_plus_f['ratio']:.2f} [{shape}]")
        rows[f"flash_bwd_dq/{tag}"] = dict(
            err=tiles_dq["dq"][0], tiles=tiles_dq, library_ms=lib,
            library=backend, shape=shape, e_plus_f=e_plus_f,
            bound=bound(in_bytes + dq.numel() * 2, 6 * d * pairs),
            **timings(KERNELS["flash_bwd_dq"], args_e,
                      lambda: fa.flash_bwd_dq(*ins, causal=True),
                      lambda: fa.plain_flash_bwd_dq(*ins, causal=True)))
        rows[f"flash_bwd_dkv/{tag}"] = dict(
            err=max(t[0] for t in tiles_dkv.values()), tiles=tiles_dkv,
            library_ms=lib, library=backend, shape=shape, e_plus_f=e_plus_f,
            bound=bound(in_bytes + (dk.numel() + dv.numel()) * 2,
                        8 * d * pairs),
            **timings(KERNELS["flash_bwd_dkv"], args_f,
                      lambda: fa.flash_bwd_dkv(*ins, causal=True),
                      lambda: fa.plain_flash_bwd_dkv(*ins, causal=True)))
        del q, k, v, do, out, lse, delta, ins, dq, dk, dv, args_e, args_f
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    for name, r in rows.items():
        log(f"kernel {name}: max_abs_err {r['err']:.3e}, kernel "
            f"{r['ms']:.4f} ms (wrapper {r['wrapper_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms by "
            f"{r['bound'][1]}, library {r['library_ms']} "
            f"{r.get('library', 'SDPA')}) [{r['shape']}]")
        log_tiles(name, r)
        log_turns(name, r)
    return rows


def log_tiles(name: str, r: dict) -> None:
    """A row's :func:`close_tiles` readings, one line per tensor."""
    for t, (err, scale, worst) in r.get("tiles", {}).items():
        log(f"kernel {name} {t}: max abs err {err:.3e}, max |plain| "
            f"{scale:.3e}, worst {TILE}-row tile err / tile max |plain| "
            f"{worst:.3e} (gate {BWD_REL})")


def log_turns(name: str, r: dict) -> None:
    """A row's :func:`in_turns` readings and the kernel / library ratio."""
    if "turns" in r:
        lib0, k0, k1, lib1 = r["turns"]
        log(f"kernel {name} in turns: library {lib0:.4f}, kernel {k0:.4f}, "
            f"kernel {k1:.4f}, library {lib1:.4f} ms; kernel / library "
            f"{r['ms'] / r['library_ms']:.2f}")


def tile_checks(torch, pa, KERNELS, H=32, K=8, d=128, suffix="", seed=9012):
    """Kernel I at the serve shapes (H=32, K=8, d=128 by default, block 128,
    16 blocks a slot): a t=1 tile over 8 slots at kernel A's pasts (38-1101,
    two empty; the decode regime at rep <= 16), and a t=700 tile over 4
    slots from position 0 (phase 7's prompt step; the flash regime). Held
    per 64-row tile, slot and head (:func:`close_tiles`): late causal rows
    average hundreds of columns and are small, so one tensor-wide tolerance
    would let a fault in the late columns pass. Each call must be one launch
    on the card (``launches_per_call``, the profiler's count) and two
    launches must give the same bits. The t=1 tile is shorter than its
    launch from Python: its kernel time comes from a CUDA graph of launches
    (``loop_ms``: the loop). The rows' keys end in ``suffix``."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    bs, nb_max, n_slots = 128, 16, 8
    nbp1 = n_slots * nb_max + 1
    kpool, vpool = (make_pool(torch, g, 2, nbp1, bs, K * d, dev) for _ in "kv")
    bt = torch.randperm(nbp1 - 1, generator=g, device=dev).to(
        torch.int32).reshape(n_slots, nb_max).contiguous()
    S, layer, rows = nb_max * bs, 1, {}
    for key, t, pos in (("paged_tile", 700, [0, 0, 0, 0]),
                        ("paged_tile/decode", 1,
                         [38, 129, 130, 701, 301, 1101, 0, 0])):
        ps = torch.tensor(pos, dtype=torch.int32, device=dev)
        B = len(pos)
        q = torch.randn(B, t, H, d, generator=g, device=dev).bfloat16()
        btb = bt[:B].contiguous()

        def call():
            return pa.paged_attention(q, kpool, vpool, btb, ps, layer=layer)

        out = call()
        ref = pa.plain_paged_attention(q, kpool, vpool, btb, ps, layer=layer)
        tag = f"I (t={t}{suffix})"
        tiles = {"out": close_tiles(f"{tag} out", out, ref)}
        launches = one_call(torch, tag, call)
        cols = sum(min(p + t, S) for p in pos)       # KV rows read per slot
        pairs = sum(min(p + i, S - 1) + 1 for p in pos for i in range(t))
        nbytes = cols * K * d * 2 * 2 + (q.numel() + out.numel()) * 2

        def make_args():
            return pa.paged_tile_kernel_args(q, kpool, vpool, btb, ps,
                                             layer=layer)[0]

        rows[key + suffix] = dict(
            err=tiles["out"][0], tiles=tiles, launches_per_call=launches,
            bound=bound(nbytes, 4 * H * d * pairs), library_ms=None,
            **timings(KERNELS["paged_tile"], make_args(), call,
                      lambda: pa.plain_paged_attention(q, kpool, vpool, btb,
                                                       ps, layer=layer),
                      make_args if t == 1 else None),
            shape=f"B={B} t={t}, H={H} K={K} d={d} bs=128, pos "
                  + ",".join(map(str, pos)))
        del q, out, ref
    return rows


def rms_checks(torch, rn, KERNELS):
    """Kernel J on llama3-8b rows (D=4096): [4096, 4096] and [6, 4096] bf16
    with a bf16 weight, [4096, 4096] fp32 with an fp32 weight; forward
    against the plain version and the gradients of ``fused_rms_norm``
    (kernel J forward, closed-form backward) against autograd through the
    plain version, at ``RMS_TOL``; timed beside ``F.rms_norm``."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3456)
    D, rows = 4096, {}
    for key, n, dt in (("rms_norm", 4096, torch.bfloat16),
                       ("rms_norm/decode", 6, torch.bfloat16),
                       ("rms_norm/fp32", 4096, torch.float32)):
        tol = RMS_TOL[str(dt).replace("torch.", "")]
        x = (2 * torch.randn(n, D, generator=g, device=dev)).to(dt)
        w = (1 + 0.3 * torch.randn(D, generator=g, device=dev)).to(dt)
        gy = torch.randn(n, D, generator=g, device=dev)
        got = []
        for fn in (rn.fused_rms_norm, rn.plain_rms_norm):
            xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
            y = fn(xx, ww)
            (y.float() * gy).sum().backward()
            got.append((y.detach(), xx.grad, ww.grad))
        errs = [close(f"J {part} ({key})", a, b, tol, tol)
                for part, a, b in zip(("out", "dx", "dw"), *got)]
        nbytes = (2 * x.numel() + w.numel()) * x.element_size()
        lib = time_ms(lambda: torch.nn.functional.rms_norm(x, (D,), w, 1e-5))
        args, _ = rn.rms_kernel_args(x, w)
        rows[key] = dict(
            err=errs[0], grad_err=max(errs[1:]), library_ms=lib,
            library="torch.nn.functional.rms_norm",
            bound=bound(nbytes, 4 * x.numel(), FP32_FLOPS_PER_S),
            **timings(KERNELS["rms_norm"], args,
                      lambda: rn.rms_norm_forward(x, w),
                      lambda: rn.plain_rms_norm(x, w)),
            shape=f"[{n}, {D}] {str(dt).replace('torch.', '')}")
        del x, w, gy, got
    return rows


def stream_checks(torch, hb, KERNELS):
    """Kernel K on the probe's array (256 MB fp32, ``arange``, five times
    the L2) against its plain version (relative ``STREAM_REL``), timed
    beside ``torch.sum``."""
    x = torch.arange(64 * 1024 * 1024, dtype=torch.float32,
                     device="cuda").reshape(-1, hb.ROW)
    got, want = hb.hbm_stream(x, 3), hb.plain_hbm_stream(x, 3)
    err = abs(float(got) - float(want))
    if not err <= STREAM_REL * abs(float(want)):
        raise AssertionError(f"K: sum {float(got)} vs plain {float(want)}")
    args, _ = hb.hbm_stream_kernel_args(x, 3)
    row = dict(err=err, library_ms=time_ms(lambda: torch.sum(x)),
               library="torch.sum",
               bound=bound(x.numel() * 4, x.numel(), FP32_FLOPS_PER_S),
               **timings(KERNELS["hbm_stream"], args,
                         lambda: hb.hbm_stream(x, 3),
                         lambda: hb.plain_hbm_stream(x, 3)),
               shape="[65536, 1024] fp32 (256 MB), 1024 chunks of 64 rows")
    del x
    return {"hbm_stream": row}


def probe_checks(torch, pa, KERNELS, reset_counts):
    """Phase 3's I/J/K rows, then J's and K's own entry points run with the
    counts set to 0 just before: ``measure_hbm_bandwidth()`` (K) and the
    op builder's ``fused_rms_norm`` forward and backward on a decode-step
    hidden state (J). Returns (rows, the entry points' launches, rates)."""
    from deepspeed_tpu_torch.ops import get_op_builder
    from deepspeed_tpu_torch.ops import rms_norm as rn
    from deepspeed_tpu_torch.tools import hbm_bandwidth as hb

    rows = tile_checks(torch, pa, KERNELS)
    for sfx, H, K, d in HEAD_DIM_SHAPES:
        rows.update(tile_checks(torch, pa, KERNELS, H, K, d, sfx,
                                seed=9012 + d))
    rows.update(rms_checks(torch, rn, KERNELS))
    rows.update(stream_checks(torch, hb, KERNELS))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reset_counts()
    rates = hb.measure_hbm_bandwidth()
    x = torch.randn(6, 4096, device="cuda").bfloat16().requires_grad_()
    w = torch.ones(4096, device="cuda").bfloat16().requires_grad_()
    get_op_builder("rms_norm").load()(x, w).float().sum().backward()
    torch.cuda.synchronize()
    counts = {k: KERNELS[k].launches for k in ("rms_norm", "hbm_stream")}
    missing = [k for k, c in counts.items() if c == 0]
    if missing:
        raise AssertionError(f"entry points never launched {missing}")
    for name, r in rows.items():
        extra = (f", grads max abs err {r['grad_err']:.3e}"
                 if "grad_err" in r else "")
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms {r['library']}")
        log(f"kernel {name}: max_abs_err {r['err']:.3e}{extra}, kernel "
            f"{r['ms']:.4f} ms (wrapper {r['wrapper_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms by "
            f"{r['bound'][1]}, library {lib}) [{r['shape']}]")
        log_tiles(name, r)
    log(f"probe [{card_line()}]: measure_hbm_bandwidth copy_rw "
        f"{rates['copy_rw_gbps']:.1f} GB/s, stream_read (kernel K) "
        f"{rates['stream_read_gbps']:.1f} GB/s, data sheet 3350 GB/s; "
        f"entry-point launches {counts}")
    return rows, counts, rates


# ---------------------------------------------------------------------------
# phase 4: serve Llama-3-8B through the engine
# ---------------------------------------------------------------------------

class Replay:
    """Wraps the four kernel wrappers for the serve phase (module attributes,
    restored on exit) and captures one launch of each per stage -- inputs
    cloned, a pool as the one layer read -- to replay through the plain
    version afterwards. Stage ``put``: the first call of each kernel.
    Stage ``decode_batch``: the first call of kernel A whose rows sit past
    the pool frontier (``row_pos != atom_pos0``: the fused decode loop's
    tail steps)."""

    REQUIRED = {("paged_decode", "put"), ("paged_past", "put"),
                ("chunk_self", "put"), ("flash_fwd", "put"),
                ("paged_decode", "decode_batch")}

    def __init__(self, torch, pa, fa):
        self.torch = torch
        self.stage = None
        self.captured = {}
        self.tiles = {}        # backward kernels: close_tiles' readings
        self.target_of = {}    # captured kernel -> its wrapper's target
        self.targets = self.make_targets(pa, fa)

    @staticmethod
    def make_targets(pa, fa):
        """kernel name -> (module, wrapper attribute, plain version)"""
        return {
            "paged_decode": (pa, "decode_pool_partials",
                             pa.plain_decode_partials),
            "paged_past": (pa, "past_partials", pa.plain_past_partials),
            "chunk_self": (pa, "self_attention", pa.plain_self_attention),
            "flash_fwd": (fa, "flash_forward", fa.plain_flash_forward),
        }

    def __enter__(self):
        for name, (mod, attr, _) in self.targets.items():
            setattr(mod, attr, self._wrap(name, getattr(mod, attr)))
        return self

    def __exit__(self, *exc):
        for mod, attr, _ in self.targets.values():
            setattr(mod, attr, getattr(mod, attr).__wrapped__)

    def kernel_of(self, target, x):
        """The kernel a call of ``target``'s wrapper launched (None: none):
        A's and B's wrappers over an int pool launch its int mode."""
        if x.get("kv_scale") is not None:
            return f"{target}_int{x['kv_bits']}"
        return target

    def _wanted(self, target, name, x) -> bool:
        if name is None or (name, self.stage) in self.captured:
            return False
        if self.stage == "decode_batch" and target == "paged_decode":
            return (x["row_pos"] is not None
                    and bool((x["row_pos"] != x["atom_pos0"]).any()))
        return True

    def _wrap(self, target, fn):
        sig = inspect.signature(fn)
        torch = self.torch

        def clone(v):
            if isinstance(v, torch.Tensor):
                return v.clone()
            return tuple(t.clone() for t in v) if isinstance(v, tuple) else v

        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            x = dict(bound.arguments)
            name = self.kernel_of(target, x)
            if self._wanted(target, name, x):
                i = x.get("layer")
                names = [n for n in ("k_pool", "v_pool", "kv_scale", "packed",
                                     "scales") if x.get(n) is not None]
                if i is not None and names:    # keep the one layer read
                    for n in names:
                        x[n] = x[n][i:i + 1]
                    x["layer"] = 0
                outs = out if isinstance(out, tuple) else (out,)
                self.target_of[name] = target
                self.captured[(name, self.stage)] = (
                    {k: clone(v) for k, v in x.items()}, clone(outs))
            return out

        wrapper.__wrapped__ = fn
        return wrapper

    def check(self):
        missing = self.REQUIRED - set(self.captured)
        if missing:
            raise AssertionError(f"no launch captured for "
                                 f"{sorted(missing)}")
        errs = {}
        for (name, stage), (x, out) in sorted(self.captured.items()):
            plain = self.targets[self.target_of[name]][2]
            ref = plain(**x)
            tag = f"replay {name} ({stage})"
            if name.startswith(("paged_decode", "paged_past")):
                live = ref[2] > 0
                errs[f"{name}/{stage}"] = close(
                    tag, normalised(out[0], out[2])[live],
                    normalised(ref[0], ref[2])[live], ATOL, RTOL)
                close(f"{tag} m", out[1][live], ref[1][live], STAT_TOL,
                      STAT_TOL)
            elif name in ("chunk_self", "qmm", "qmm_stacked"):
                errs[f"{name}/{stage}"] = close(tag, out[0], ref, ATOL, RTOL)
            elif name == "paged_tile":
                self.tiles[f"{name}/{stage} out"] = close_tiles(
                    f"{tag} out", out[0], ref)
                errs[f"{name}/{stage}"] = self.tiles[f"{name}/{stage} out"][0]
            elif name in ("flash_bwd_dq", "flash_bwd_dkv"):
                grads = ("dq",) if name == "flash_bwd_dq" else ("dk", "dv")
                refs = ref if isinstance(ref, tuple) else (ref,)
                for t, got, want in zip(grads, out, refs):
                    self.tiles[f"{name}/{stage} {t}"] = close_tiles(
                        f"{tag} {t}", got, want)
                errs[f"{name}/{stage}"] = max(
                    self.tiles[f"{name}/{stage} {t}"][0] for t in grads)
            else:
                errs[f"{name}/{stage}"] = close(tag, out[0], ref[0], ATOL,
                                                RTOL)
                close(f"{tag} lse", out[1], ref[1], STAT_TOL, STAT_TOL)
        return errs


class QuantReplay(Replay):
    """The serve-quant phase's :class:`Replay` of the new kernels: G/H
    (``quantized_matmul``, a call that the shape rule sends to them) and
    the int modes of A/B. Stages ``put`` (whole prompts), ``mixed`` and
    ``decode_batch``; ``kv_bits`` names the pool's A/B kernels."""

    def __init__(self, torch, pa, qm, kv_bits: int):
        self.qm = qm
        super().__init__(torch, pa, qm)
        dec, past = (f"paged_decode_int{kv_bits}", f"paged_past_int{kv_bits}")
        self.REQUIRED = {("qmm", "put"), ("qmm", "mixed"),
                         ("qmm_stacked", "mixed"), (dec, "mixed"),
                         (past, "mixed"), ("qmm", "decode_batch"),
                         ("qmm_stacked", "decode_batch"),
                         (dec, "decode_batch")}

    @staticmethod
    def make_targets(pa, qm):
        return {
            "paged_decode": (pa, "decode_pool_partials",
                             pa.plain_decode_partials),
            "paged_past": (pa, "past_partials", pa.plain_past_partials),
            "qmm": (qm, "quantized_matmul", qm.plain_quantized_matmul),
        }

    def kernel_of(self, target, x):
        if target == "qmm":
            if not self.qm.uses_kernel(x["x"], x["scales"]):
                return None
            return "qmm" if x["layer"] is None else "qmm_stacked"
        if x["kv_scale"] is None:
            return None
        return f"{target}_int{x['kv_bits']}"


class TrainReplay(Replay):
    """The train phase's :class:`Replay`: kernels D, E and F, the first
    launch of each (stage ``train``)."""

    REQUIRED = {("flash_fwd", "train"), ("flash_bwd_dq", "train"),
                ("flash_bwd_dkv", "train")}

    def __init__(self, torch, fa):
        super().__init__(torch, None, fa)

    @staticmethod
    def make_targets(pa, fa):
        return {
            "flash_fwd": (fa, "flash_forward", fa.plain_flash_forward),
            "flash_bwd_dq": (fa, "flash_bwd_dq", fa.plain_flash_bwd_dq),
            "flash_bwd_dkv": (fa, "flash_bwd_dkv", fa.plain_flash_bwd_dkv),
        }


def attention_heavy(params) -> None:
    """Rescale the random weights so attention weighs in the residual
    stream. At the reference init the token-local MLP outweighs a
    near-uniform attention average, so an attention fault barely moves the
    logits: a chunked prefill that drops one past token lands right at the
    cross-path gate (``tests/test_torch_smoke.py``). Sharper scores (wq x 4),
    a louder attention output (wo x 8) and a quieter MLP (w_down x 0.125)
    make the same fault fail the gate several times over. In place, on the
    served params."""
    params["layers"]["attn"]["wq"].mul_(4.0)
    params["layers"]["attn"]["wo"].mul_(8.0)
    params["layers"]["mlp"]["w_down"].mul_(0.125)


def serve_prompts(V):
    """The serve phases' prompts (numpy seed 0): four whole prompts of 37,
    128, 129 and 700 tokens, then two fresh ones of 300 and 1100."""
    rng = np.random.default_rng(0)

    def prompt(n):
        return rng.integers(1, V, n).astype(np.int32)

    return [prompt(n) for n in (37, 128, 129, 700)], [prompt(300),
                                                      prompt(1100)]


def check_logits(out, V):
    for uid, lg in out.items():
        if not np.all(np.isfinite(lg)) or lg.shape != (V,):
            raise AssertionError(f"uid {uid}: logits not finite / shape "
                                 f"{lg.shape}")


def serve(torch, pa, fa, KERNELS, reset_counts):
    from deepspeed_tpu_torch import InferenceEngineV2, TransformerLM, get_preset

    cfg = get_preset("llama3-8b", param_dtype="bfloat16")
    model = TransformerLM(cfg)
    t0 = time.perf_counter()
    eng = InferenceEngineV2(model, max_sequences=8, max_seq_len=2048,
                            block_size=128, device="cuda", seed=0)
    attention_heavy(eng.params)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for grp in (eng.params["embed"],
                                         eng.params["final_norm"])
                   for p in grp.values())
    n_params += sum(p.numel() for grp in eng.params["layers"].values()
                    for p in grp.values())
    pool_gb = 2 * eng.cache["k"].numel() * 2 / 1e9
    log(f"serve: llama3-8b D={cfg.hidden_size} L={cfg.num_layers} "
        f"H={cfg.num_heads}/{cfg.num_kv_heads} F={cfg.intermediate_size} "
        f"V={cfg.vocab_size}: {n_params / 1e9:.3f}B params, KV pool "
        f"{pool_gb:.2f} GB, built in {time.perf_counter() - t0:.1f} s")
    V = cfg.vocab_size

    def finite(out):
        check_logits(out, V)

    firsts, fresh = serve_prompts(V)
    torch.cuda.synchronize()
    reset_counts()
    with Replay(torch, pa, fa) as replay:
        replay.stage = "put"
        t = time.perf_counter()
        out1 = eng.put([0, 1, 2, 3], firsts)
        dt_prefill = time.perf_counter() - t
        finite(out1)
        nxt = [int(np.argmax(out1[u])) for u in range(4)]

        t = time.perf_counter()
        out2 = eng.put([0, 1, 2, 3, 4, 5],
                       [np.array([x], np.int32) for x in nxt] + fresh)
        dt_mixed = time.perf_counter() - t
        finite(out2)
        nxt = [int(np.argmax(out2[u])) for u in range(6)]

        replay.stage = "decode_batch"
        t = time.perf_counter()
        toks = eng.decode_batch(list(range(6)), nxt, steps=32)
        dt_decode = time.perf_counter() - t
    counts = {name: KERNELS[name].launches for name in SERVE_KERNELS}
    for u, tk in toks.items():
        if tk.shape != (32,) or tk.min() < 0 or tk.max() >= V:
            raise AssertionError(f"uid {u}: bad decoded tokens {tk}")
    missing = [n for n, c in counts.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched in the serve phase: "
                             f"{missing} (counts {counts})")
    log(f"serve: launches {counts}")

    # cross-path: chunked 1100-token prefill vs one whole-prompt put
    whole = eng.put([6], [fresh[1]])[6]
    chunked = out2[5]
    rel = float(np.linalg.norm(chunked - whole) / np.linalg.norm(whole))
    log(f"serve: 1100-token prompt, chunked vs whole-prompt last logits: "
        f"rel L2 {rel:.3e}, max abs {np.abs(chunked - whole).max():.3e}, "
        f"argmax {int(np.argmax(chunked))} vs {int(np.argmax(whole))}")
    if not rel <= CROSS_PATH_REL_L2:
        raise AssertionError(f"cross-path mismatch: rel L2 {rel} > "
                             f"{CROSS_PATH_REL_L2}")
    replay_errs = replay.check()
    log(f"serve: captured launches replayed vs plain, max abs err "
        f"{replay_errs}")
    name = torch.cuda.get_device_name(0)
    n_prefill = sum(len(p) for p in firsts)
    n_mixed = 4 + sum(len(p) for p in fresh)
    log(f"serve [{name}]: whole-prompt prefill {n_prefill / dt_prefill:.1f} "
        f"tokens/s ({n_prefill} tokens, {dt_prefill * 1e3:.1f} ms, first "
        f"step of the process), mixed chunked step {n_mixed / dt_mixed:.1f} "
        f"tokens/s ({dt_mixed * 1e3:.1f} ms), decode_batch "
        f"{6 * 32 / dt_decode:.1f} tokens/s (6 x 32, {dt_decode * 1e3:.1f} "
        f"ms)")
    eng.flush(list(range(7)))
    return counts, out1, tree_fingerprint(torch, eng.params)


# ---------------------------------------------------------------------------
# phase 6: serve Llama-3-8B with int8/int4 weights and an int8/int4 KV pool
# ---------------------------------------------------------------------------

QUANT_ENGINES = (("Q1", "int4", "int8"), ("Q2", "int8", "int4"))
QUANT_KERNELS = ("qmm", "qmm_stacked", "paged_decode_int8",
                 "paged_decode_int4", "paged_past_int8", "paged_past_int4")


def tree_bytes(tree) -> int:
    """Bytes of a parameter tree (tensors and QuantizedWeights)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.nbytes


def serve_params(torch, cfg, device="cuda"):
    """Phase 4's weights: seed-0 random bf16 on the card, rescaled by
    :func:`attention_heavy`."""
    from deepspeed_tpu_torch import TransformerLM

    params = TransformerLM(cfg).init(seed=0, device=device)
    attention_heavy(params)
    return params


def tree_fingerprint(torch, tree) -> list:
    """Every 1009th element of each leaf of a parameter tree, in fp64 on the
    host, leaves in key order: equal for two trees built alike, bit for
    bit, and cheap to keep where the trees themselves are not."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_fingerprint(torch,
                                                                  tree[k])]
    return [tree.reshape(-1)[::1009].to(torch.float64).cpu()]


def dequantized_tree(torch, qm, params):
    """A quantized serving tree with every QuantizedWeight expanded to the
    dense bf16 weight it stands for (``dequantize_matmul_weight``, per
    layer), held in the scales' (compute) dtype; the head becomes an untied
    ``lm_head``."""
    from deepspeed_tpu_torch.models.transformer import QuantizedWeight

    def dense(qw):
        ps, ss = ((qw.packed, qw.scales) if qw.packed.ndim == 2
                  else (qw.packed.unbind(0), qw.scales.unbind(0)))
        if qw.packed.ndim == 2:
            w = qm.dequantize_matmul_weight(ps, ss, qw.bits, qw.din)
        else:
            w = torch.stack([qm.dequantize_matmul_weight(p, sc, qw.bits,
                                                         qw.din)
                             for p, sc in zip(ps, ss)])
        return w.to(qw.scales.dtype)

    layers = {grp: {n: dense(w) if isinstance(w, QuantizedWeight) else w
                    for n, w in sub.items()}
              for grp, sub in params["layers"].items()}
    out = {k: v for k, v in params.items() if k not in ("layers",
                                                         "lm_head_q")}
    out["layers"] = layers
    out["lm_head"] = dense(params["lm_head_q"])
    return out


def weight_cross_check(torch, qm, KERNELS):
    """int8 and int4 weights through G/H against an engine served the dense
    bf16 weights they dequantize to, at 2 layers of llama3-8b's width
    (seed-0 weights at the reference init scale): the last-token logits of
    a whole-prompt ``put`` (2 prompts, 256 rows: H takes every layer
    product, G the head), rel L2 <= WEIGHT_REL_L2."""
    import dataclasses

    from deepspeed_tpu_torch import InferenceEngineV2, TransformerLM, get_preset

    cfg = dataclasses.replace(get_preset("llama3-8b", param_dtype="bfloat16"),
                              num_layers=2)
    kw = dict(max_sequences=4, max_seq_len=512, block_size=128,
              device="cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (100, 60)]
    rel = {}
    for bits in (8, 4):
        params = TransformerLM(cfg).init(seed=0, device="cuda")
        eng = InferenceEngineV2(TransformerLM(cfg), params,
                                weight_dtype=f"int{bits}", **kw)
        del params
        n = {k: KERNELS[k].launches for k in ("qmm", "qmm_stacked")}
        got = eng.put([0, 1], prompts)
        if any(KERNELS[k].launches == c for k, c in n.items()):
            raise AssertionError("weight cross-check: G/H did not launch")
        ref_eng = InferenceEngineV2(
            TransformerLM(dataclasses.replace(cfg, tie_embeddings=False)),
            dequantized_tree(torch, qm, eng.params), **kw)
        want = ref_eng.put([0, 1], prompts)
        rel[f"int{bits}"] = max(
            float(np.linalg.norm(got[u] - want[u]) / np.linalg.norm(want[u]))
            for u in (0, 1))
        del eng, ref_eng
        gc.collect()
        torch.cuda.empty_cache()
    log(f"serve-quant: weight cross-check at 2 layers, G/H vs dense bf16 "
        f"dequantized weights, last-token logits rel L2 {rel} (gate "
        f"{WEIGHT_REL_L2})")
    bad = {k: r for k, r in rel.items() if not r <= WEIGHT_REL_L2}
    if bad:
        raise AssertionError(f"weight cross-check: rel L2 {bad} > "
                             f"{WEIGHT_REL_L2}")
    return rel


def serve_quant(torch, pa, qm, KERNELS, reset_counts, bf16_logits):
    """``InferenceEngineV2`` on llama3-8b at full width and depth from phase
    4's weights, Q1 (int4 weights, int8 pool) then Q2 (int8 weights, int4
    pool), each on phase 4's traffic under a :class:`QuantReplay`, then
    freed; then the weight cross-check. Returns launches per kernel, summed
    over the two engines."""
    from deepspeed_tpu_torch import InferenceEngineV2, TransformerLM, get_preset

    cfg = get_preset("llama3-8b", param_dtype="bfloat16")
    V = cfg.vocab_size
    firsts, fresh = serve_prompts(V)
    name = torch.cuda.get_device_name(0)
    total = dict.fromkeys(QUANT_KERNELS, 0)
    for tag, wd, kd in QUANT_ENGINES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = serve_params(torch, cfg)
        dense_bytes = tree_bytes(params)
        eng = InferenceEngineV2(TransformerLM(cfg), params, max_sequences=8,
                                max_seq_len=2048, block_size=128,
                                device="cuda", weight_dtype=wd, kv_dtype=kd)
        del params
        gc.collect()
        torch.cuda.synchronize()
        q_bytes = tree_bytes(eng.params)
        pool_gb = sum(t.numel() * t.element_size()
                      for t in eng.cache.values()) / 1e9
        log(f"serve-quant {tag}: weight_dtype={wd} kv_dtype={kd}: served "
            f"tree {q_bytes / 1e9:.3f} GB against {dense_bytes / 1e9:.3f} GB "
            f"bf16 ({q_bytes / dense_bytes:.4f}), KV pool {pool_gb:.3f} GB, "
            f"built in {time.perf_counter() - t0:.1f} s")
        bits = int(kd[-1])
        reset_counts()
        with QuantReplay(torch, pa, qm, bits) as replay:
            replay.stage = "put"
            t = time.perf_counter()
            out1 = eng.put([0, 1, 2, 3], firsts)
            dt_prefill = time.perf_counter() - t
            check_logits(out1, V)
            nxt = [int(np.argmax(out1[u])) for u in range(4)]
            replay.stage = "mixed"
            t = time.perf_counter()
            out2 = eng.put([0, 1, 2, 3, 4, 5],
                           [np.array([x], np.int32) for x in nxt] + fresh)
            dt_mixed = time.perf_counter() - t
            check_logits(out2, V)
            nxt = [int(np.argmax(out2[u])) for u in range(6)]
            replay.stage = "decode_batch"
            t = time.perf_counter()
            toks = eng.decode_batch(list(range(6)), nxt, steps=32)
            dt_decode = time.perf_counter() - t
        counts = {k: KERNELS[k].launches for k in QUANT_KERNELS}
        for u, tk in toks.items():
            if tk.shape != (32,) or tk.min() < 0 or tk.max() >= V:
                raise AssertionError(f"{tag} uid {u}: bad decoded tokens {tk}")
        want = {"qmm", "qmm_stacked", f"paged_decode_{kd}",
                f"paged_past_{kd}"}
        missing = [k for k in want if counts[k] == 0]
        if missing:
            raise AssertionError(f"serve-quant {tag}: kernels never launched: "
                                 f"{missing} (counts {counts})")
        errs = replay.check()
        rel = {u: float(np.linalg.norm(out1[u] - bf16_logits[u])
                        / np.linalg.norm(bf16_logits[u])) for u in range(4)}
        peak = torch.cuda.max_memory_allocated() / 1e9
        n_prefill = sum(len(p) for p in firsts)
        n_mixed = 4 + sum(len(p) for p in fresh)
        log(f"serve-quant {tag}: launches {counts}; captured launches "
            f"replayed vs plain, max abs err {errs}")
        log(f"serve-quant {tag}: whole-prompt last-token logits vs phase "
            f"4's bf16 engine, rel L2 {rel} (no gate: quantization error)")
        log(f"serve-quant {tag} [{name}]: whole-prompt prefill "
            f"{n_prefill / dt_prefill:.1f} tokens/s ({dt_prefill * 1e3:.1f} "
            f"ms), mixed chunked step {n_mixed / dt_mixed:.1f} tokens/s "
            f"({dt_mixed * 1e3:.1f} ms), decode_batch "
            f"{6 * 32 / dt_decode:.1f} tokens/s (6 x 32, "
            f"{dt_decode * 1e3:.1f} ms), peak memory {peak:.2f} GB")
        for k, c in counts.items():
            total[k] += c
        del eng, replay
    gc.collect()
    torch.cuda.empty_cache()
    weight_cross_check(torch, qm, KERNELS)
    return total


# ---------------------------------------------------------------------------
# phase 7: the dense-tile and dense-cache engines and init_inference's v1
# ---------------------------------------------------------------------------

DENSE_ENGINES = (("a", dict(packed=False)), ("b", dict(paged=False)))
DENSE_DECODE_PUTS = 16
V1_NEW_TOKENS = 16


class DenseReplay(Replay):
    """Phase 7's :class:`Replay` of kernel I: its first launch (stage
    ``put``: the prompt step's tile) through ``plain_paged_attention``,
    held per 64-row tile like phase 3's."""

    REQUIRED = {("paged_tile", "put")}

    @staticmethod
    def make_targets(pa, fa):
        return {"paged_tile": (pa, "paged_attention",
                               pa.plain_paged_attention)}


def rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def max_rel_l2(got, want) -> float:
    """The largest :func:`rel_l2` over every uid of every ``put``."""
    return max(rel_l2(o[u], w[u]) for o, w in zip(got, want) for u in w)


def dense_traffic(eng, prompts, steps: int, feeds=None, first_uid: int = 0):
    """``prompts`` (uids ``first_uid``..) in one ``put``, then ``steps``
    single-token ``put`` steps of every uid, fed ``feeds[s]`` or, without
    ``feeds``, the engine's own argmax. Returns (logits of every put, the
    tokens fed, the prompt put's seconds, each decode put's seconds)."""
    uids = list(range(first_uid, first_uid + len(prompts)))
    t = time.perf_counter()
    outs = [eng.put(uids, prompts)]
    t_prompt = time.perf_counter() - t
    fed, t_dec = [], []
    for s in range(steps):
        toks = (feeds[s] if feeds is not None
                else [int(np.argmax(outs[-1][u])) for u in uids])
        fed.append(toks)
        t = time.perf_counter()
        outs.append(eng.put(uids, [np.array([x], np.int32) for x in toks]))
        t_dec.append(time.perf_counter() - t)
    return outs, fed, t_prompt, t_dec


def v1_generate(eng, ids, new_tokens: int):
    """``eng.generate`` (greedy) with the last-row logits of every
    ``forward_with_cache`` step captured: the prompt step, then one step
    per new token but the last. Returns (the new tokens [B, n], each
    step's logits as ``{row: [V]}``, seconds; the capture's copy to the
    host is inside the time)."""
    model, steps = eng.module, []
    real = model.forward_with_cache

    def capture(params, input_ids, cache):
        logits, cache = real(params, input_ids, cache)
        last = logits[:, -1].float().cpu().numpy()
        steps.append(dict(enumerate(last)))
        return logits, cache

    wrapped = "forward_with_cache" in vars(model)     # a harness wrapper
    model.forward_with_cache = capture
    try:
        t = time.perf_counter()
        gen = eng.generate(ids, max_new_tokens=new_tokens)
        dt = time.perf_counter() - t
    finally:
        if wrapped:
            model.forward_with_cache = real
        else:
            del model.forward_with_cache
    T, V = ids.shape[1], model.cfg.vocab_size
    if gen.shape != (len(ids), T + new_tokens) or gen.min() < 0 \
            or gen.max() >= V or not np.array_equal(gen[:, :T], ids):
        raise AssertionError(f"serve-dense (c): bad generate output "
                             f"{gen.shape}")
    return gen[:, T:], steps, dt


@contextlib.contextmanager
def swapped(mod, attr, make):
    """``mod.attr`` replaced by ``make(mod.attr)`` inside the block."""
    real = getattr(mod, attr)
    setattr(mod, attr, make(real))
    try:
        yield
    finally:
        setattr(mod, attr, real)


def drops_newest_column(fn):
    """A faulty kernel-I stand-in ((a)): ``fn`` with every row's newest
    visible column (its own position) dropped."""
    def faulty(q, k_pool, v_pool, block_tables, pos, window=None, layer=0):
        return fn(q, k_pool, v_pool, block_tables, pos - 1, window, layer)
    return faulty


def cached_drops_newest_column(fn):
    """A faulty ``_cached_attention`` stand-in ((b) and (c)): ``fn`` with
    every row's newest visible column dropped from its mask."""
    def faulty(q, k, v, valid):
        kept = valid.clone()
        kept[..., :-1] &= valid[..., 1:]
        kept[..., -1] = False
        return fn(q, k, v, kept)
    return faulty


def free_card(torch, device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def owns_no_copy(tree, params, tag: str) -> None:
    a, b = tree["layers"]["attn"]["wq"], params["layers"]["attn"]["wq"]
    if a.data_ptr() != b.data_ptr():
        raise AssertionError(f"serve-dense ({tag}): the engine copied the "
                             f"weight tree")


def dense_engine(torch, model, tree, tag: str, device, v1: bool = False,
                 **kw):
    """A fresh engine on ``tree`` (the last one freed first):
    ``init_inference``'s with ``v1``, else ``InferenceEngineV2(**kw)``."""
    import deepspeed_tpu_torch as tds

    free_card(torch, device)
    if v1:
        eng = tds.init_inference(model, params=tree, device=device)
    else:
        eng = tds.InferenceEngineV2(model, tree, device=device, **kw)
    owns_no_copy(tree, eng.params, tag)
    return eng


def dense_runs(torch, pa, model, tree, prompts, v1_ids, steps: int,
               device="cuda", noise_floor: bool = False, **engine_kw):
    """Phase 7's engines on one weight tree, on any device. First (c)
    ``init_inference(model, params=tree)``: ``forward``'s last-row logits
    of ``v1_ids`` and a greedy ``generate`` of ``V1_NEW_TOKENS`` with every
    step's logits captured. Then a packed engine runs the traffic (feeding
    its own argmax), and ``v1_ids`` as a whole-prompt ``put`` followed by
    one single-token ``put`` per token ``generate`` chose; with
    ``noise_floor`` a second packed engine runs the same traffic with the
    prompts put one at a time (other batch shapes, the same function: its
    distance from the first is the bf16 noise of this model); then (a)
    ``packed=False`` under a :class:`DenseReplay` and (b) ``paged=False``
    run the traffic fed the first engine's tokens. Engines share ``tree``
    (none copies it; checked) and each is freed before the next. Returns
    ``rel`` (the largest relative L2 of any logits vector against the
    packed engine's: ``forward``, (c)'s ``generate`` steps, (a), (b),
    ``noise``), I's replay errors and tiles, timings, the generated tokens
    and ``ref``, the packed engine's readings for :func:`dense_controls`;
    raises on a copy, a non-finite logit or a bad ``generate`` output."""
    def engine(tag, **kw):
        return dense_engine(torch, model, tree, tag, device, **kw,
                            **engine_kw)

    V = model.cfg.vocab_size
    uids = list(range(len(prompts)))
    v1_first = len(prompts)
    ids = np.stack(v1_ids)
    res = {"engines": {}, "rel": {}}
    # (c) first: its greedy tokens feed the packed engine's v1 puts
    eng = engine("c", v1=True)
    fwd = eng.forward(ids)[:, -1].float().cpu().numpy()
    free_card(torch, device)
    gen, got_c, dt = v1_generate(eng, ids, V1_NEW_TOKENS)
    res["generated"], res["engines"]["c"] = gen, (dt, None)
    del eng
    eng = engine("packed")
    want, feeds, tp, td = dense_traffic(eng, prompts, steps)
    want_c, _, _, _ = dense_traffic(eng, list(v1_ids), V1_NEW_TOKENS - 1,
                                    feeds=gen.T, first_uid=v1_first)
    res["engines"]["packed"] = (tp, td)
    del eng
    # (c)'s rows are 0.., the packed engine's v1 uids v1_first..
    want_c = [{u - v1_first: x for u, x in w.items()} for w in want_c]
    res["rel"]["forward"] = max_rel_l2([dict(enumerate(fwd))], want_c)
    res["rel"]["c"] = max_rel_l2(got_c, want_c)
    if noise_floor:
        eng = engine("noise")
        got = [{}]
        for u, prompt in zip(uids, prompts):
            got[0].update(eng.put([u], [prompt]))
        for toks in feeds:
            got.append(eng.put(uids, [np.array([x], np.int32)
                                      for x in toks]))
        res["rel"]["noise"] = max_rel_l2(got, want)
        del eng, got
    for tag, kw in DENSE_ENGINES:
        eng = engine(tag, **kw)
        replay = DenseReplay(torch, pa, None)
        with replay:
            replay.stage = "put"
            got, _, tp, td = dense_traffic(eng, prompts, steps, feeds)
        for outs in got:
            check_logits(outs, V)
        res["rel"][tag] = max_rel_l2(got, want)
        res["engines"][tag] = (tp, td)
        if tag == "a":
            res["replay"], res["replay_tiles"] = replay.check(), replay.tiles
        del eng, got, replay
    free_card(torch, device)
    res["ref"] = dict(want=want, feeds=feeds, want_c=want_c, ids=ids)
    return res


def dense_controls(torch, pa, model, tree, prompts, ref, device="cuda",
                   **engine_kw):
    """(a), (b) and (c) of :func:`dense_runs` again, with each row's newest
    visible column dropped from their attention (:func:`drops_newest_column`
    in place of kernel I's wrapper, :func:`cached_drops_newest_column` in
    place of the dense cache's ``_cached_attention``; (c) as its prompt
    step), each against the packed engine's readings ``ref``: the rel L2 a
    gate must tell apart from the sound one, per engine."""
    from deepspeed_tpu_torch.models import transformer as tm

    faults = {"a": (pa, "paged_attention", drops_newest_column),
              "b": (tm, "_cached_attention", cached_drops_newest_column)}
    want, feeds = ref["want"], ref["feeds"]
    faulty = {}
    for tag, kw in DENSE_ENGINES:
        eng = dense_engine(torch, model, tree, f"{tag}, faulty", device,
                           **kw, **engine_kw)
        with swapped(*faults[tag]):
            got, _, _, _ = dense_traffic(eng, prompts, len(feeds), feeds)
        faulty[tag] = max_rel_l2(got, want)
        del eng, got
    eng = dense_engine(torch, model, tree, "c, faulty", device, v1=True)
    with swapped(*faults["b"]):
        _, got, _ = v1_generate(eng, ref["ids"], 1)
    faulty["c"] = max_rel_l2(got, ref["want_c"][:1])
    del eng, got
    free_card(torch, device)
    return faulty


def gate_rel(tag: str, rel: dict, limits: dict) -> None:
    """Every ``rel[k]`` within ``limits[k]``."""
    bad = {k: rel[k] for k, lim in limits.items() if not rel[k] <= lim}
    if bad:
        raise AssertionError(f"{tag}: logits vs the packed engine, rel L2 "
                             f"{bad} over the limits {limits}")


def gate_controls(tag: str, faulty: dict, limits: dict, margin: float):
    """Every control's reading past ``margin`` x its gate's limit: the
    gate sees a dropped column."""
    blind = {k: faulty[k] for k, lim in limits.items()
             if k in faulty and not faulty[k] > margin * lim}
    if blind:
        raise AssertionError(f"{tag}: the gate is blind: attention that "
                             f"drops the newest column gives rel L2 {blind}, "
                             f"not past {margin} x the limits {limits}")


def dense_cross_check(torch, pa, model, tree, prompts, v1_ids, steps: int,
                      device="cuda", **engine_kw):
    """Phase 7's gate at ``DENSE_REL_L2`` where bf16 noise
    leaves it room (a shallow model of the served width, weights at the
    reference init scale): ``forward``, (c)'s ``generate`` steps, (a) and
    (b) against the packed engine, each rel L2 <= ``DENSE_REL_L2``, and
    each control (:func:`dense_controls`) past ``DENSE_CONTROL_MARGIN`` x the
    gate. Returns :func:`dense_runs`' result."""
    res = dense_runs(torch, pa, model, tree, prompts, v1_ids, steps,
                     device=device, **engine_kw)
    res["faulty"] = dense_controls(torch, pa, model, tree, prompts,
                                   res["ref"], device=device, **engine_kw)
    limits = dict.fromkeys(("forward", "a", "b", "c"), DENSE_REL_L2)
    gate_rel("serve-dense cross-check", res["rel"], limits)
    gate_controls("serve-dense cross-check", res["faulty"], limits,
                  DENSE_CONTROL_MARGIN)
    return res


def serve_dense(torch, pa, KERNELS, reset_counts):
    """Phase 7 at llama3-8b's full width and depth on phase 6's weights
    (one bf16 tree, seed 0, ``attention_heavy``), ``max_seq_len`` 2048, 8
    slots, block 128: phase 4's four prompts, 16 decode puts, v1 on four
    128-token prompts, each engine's control, then the op builder's RMSNorm
    on the card. Gates: every logits vector finite, I's first launch
    against its plain version per tile, ``forward`` within
    ``DENSE_REL_L2`` of the packed engine (the same kernels at the same
    shapes), (a), (b) and (c)'s ``generate`` steps within
    ``DENSE_FULL_REL_L2`` of the packed engine and each control past
    ``DENSE_FULL_CONTROL_MARGIN`` x its limit, I and J launched. Then
    :func:`dense_cross_check` at 2 layers of the same width. Returns the
    phase's launches per kernel."""
    import dataclasses

    from deepspeed_tpu_torch import TransformerLM, get_preset
    from deepspeed_tpu_torch.ops import get_op_builder
    from deepspeed_tpu_torch.ops import rms_norm as rn

    cfg = get_preset("llama3-8b", param_dtype="bfloat16")
    model = TransformerLM(cfg)
    tree = serve_params(torch, cfg)
    firsts, _ = serve_prompts(cfg.vocab_size)
    rng = np.random.default_rng(2)
    v1_ids = [rng.integers(1, cfg.vocab_size, 128).astype(np.int32)
              for _ in range(4)]
    kw = dict(max_sequences=8, max_seq_len=2048, block_size=128)
    torch.cuda.synchronize()
    reset_counts()
    res = dense_runs(torch, pa, model, tree, firsts, v1_ids,
                     DENSE_DECODE_PUTS, noise_floor=True, **kw)
    x = torch.randn(4, 128, cfg.hidden_size, device="cuda").bfloat16()
    w = tree["final_norm"]["scale"]
    y = get_op_builder("rms_norm").load()(x, w)
    close("J via the op builder", y.reshape(-1, cfg.hidden_size),
          rn.plain_rms_norm(x.reshape(-1, cfg.hidden_size), w),
          RMS_TOL["bfloat16"], RMS_TOL["bfloat16"])
    torch.cuda.synchronize()
    counts = {n: k.launches for n, k in KERNELS.items() if k.launches}
    res["faulty"] = dense_controls(torch, pa, model, tree, firsts,
                                   res.pop("ref"), **kw)
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    card = card_line()
    rel, faulty = res["rel"], res["faulty"]
    log(f"serve-dense: launches {counts}; kernel I's first launch replayed "
        f"vs plain, max abs err {res['replay']}, (max abs err, max |plain|, "
        f"worst {TILE}-row tile err / tile max |plain|) "
        f"{res['replay_tiles']} (gate {BWD_REL})")
    log(f"serve-dense at full depth, logits vs the packed engine, rel L2: "
        f"forward {rel['forward']:.3e} (gate {DENSE_REL_L2}); "
        + "; ".join(f"({k}) {rel[k]:.3e} (gate {DENSE_FULL_REL_L2[k]}, "
                    f"control {faulty[k]:.3e})" for k in "abc")
        + f"; the packed engine's own noise floor {rel['noise']:.3e}")
    names = {"packed": "packed (reference)", "a": "(a) packed=False",
             "b": "(b) paged=False"}
    n_prompt = sum(len(p) for p in firsts)
    for tag, (tp, td) in res["engines"].items():
        if tag == "c":
            log(f"serve-dense (c) init_inference(...).generate [{card}]: 4 x "
                f"128 prompts, {V1_NEW_TOKENS} new tokens each in "
                f"{tp * 1e3:.1f} ms ({4 * V1_NEW_TOKENS / tp:.1f} tokens/s)")
            continue
        log(f"serve-dense {names[tag]} [{card}]: prompt put "
            f"{n_prompt / tp:.1f} tokens/s ({n_prompt} tokens, "
            f"{tp * 1e3:.1f} ms), decode put {np.mean(td) * 1e3:.2f} ms "
            f"mean / {np.median(td) * 1e3:.2f} ms median over {len(td)} "
            f"(4 sequences)")
    gate_rel("serve-dense", rel, {"forward": DENSE_REL_L2,
                                  **DENSE_FULL_REL_L2})
    gate_controls("serve-dense", faulty, DENSE_FULL_REL_L2,
                  DENSE_FULL_CONTROL_MARGIN)
    if not counts.get("paged_tile") or not counts.get("rms_norm"):
        raise AssertionError(f"serve-dense: kernel I or J never launched "
                             f"(counts {counts})")
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    model2 = TransformerLM(cfg2)
    res2 = dense_cross_check(
        torch, pa, model2, model2.init(seed=0, device="cuda"), firsts,
        v1_ids, 4, **kw)
    log(f"serve-dense cross-check at 2 layers (seed-0 weights at the init "
        f"scale): logits vs the packed engine, rel L2 {res2['rel']} (gate "
        f"{DENSE_REL_L2}); controls (newest column dropped) "
        f"{res2['faulty']} (past {DENSE_CONTROL_MARGIN} x the gate)")
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 5: train Llama-3.2-1B through initialize
# ---------------------------------------------------------------------------

class plain_attention:
    """Swaps kernels D, E and F's wrappers for their plain versions (module
    attributes, restored on exit): the attention of the gradient
    cross-check's reference run."""

    def __init__(self, fa):
        self.fa = fa
        self.saved = {}

    def __enter__(self):
        for mod, attr, plain in TrainReplay.make_targets(None,
                                                         self.fa).values():
            self.saved[attr] = getattr(mod, attr)
            setattr(mod, attr, plain)
        return self

    def __exit__(self, *exc):
        for attr, fn in self.saved.items():
            setattr(self.fa, attr, fn)


def grad_rel_l2(torch, fa, model, params, batch):
    """Relative L2, per leaf, of the gradients of wq, wk, wv, wo and the
    embedding through the kernels' wrappers against those through the plain
    attention (``params`` gain ``requires_grad``)."""
    attn = params["layers"]["attn"]
    leaves = {n: attn[n] for n in ("wq", "wk", "wv", "wo")}
    leaves["embed"] = params["embed"]["tokens"]
    for t in leaves.values():
        t.requires_grad_()

    def grads():
        loss = model.loss_fn(params, batch)
        return torch.autograd.grad(loss, list(leaves.values()))

    got = grads()
    with plain_attention(fa):
        want = grads()
    return {n: float((g.float() - w.float()).norm() / w.float().norm())
            for n, g, w in zip(leaves, got, want)}


def grad_cross_check(torch, fa, batch):
    """The gradient cross-check at 2 layers of Llama-3.2-1B's width."""
    import dataclasses

    from deepspeed_tpu_torch import TransformerLM
    from deepspeed_tpu_torch.tools.train_profile import train_model_config

    model = TransformerLM(dataclasses.replace(train_model_config(),
                                              num_layers=2))
    params = model.init(seed=0, device="cuda")
    ids = {"input_ids": torch.from_numpy(batch["input_ids"]).cuda()}
    rel = grad_rel_l2(torch, fa, model, params, ids)
    log(f"train: gradient cross-check at 2 layers, kernels vs plain "
        f"attention, rel L2 {rel}")
    bad = {n: r for n, r in rel.items() if not r <= GRAD_REL_L2}
    if bad:
        raise AssertionError(f"gradient cross-check: rel L2 {bad} > "
                             f"{GRAD_REL_L2}")
    return rel


def train(torch, fa, KERNELS, reset_counts):
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch import TransformerLM
    from deepspeed_tpu_torch.models.spec import num_params
    from deepspeed_tpu_torch.tools.train_profile import (TRAIN_CONFIG,
                                                         TRAIN_SEQ,
                                                         fixed_batch,
                                                         train_model_config)

    cfg = train_model_config()
    t0 = time.perf_counter()
    eng, *_ = tds.initialize(TransformerLM(cfg), dict(TRAIN_CONFIG))
    torch.cuda.synchronize()
    n = num_params(eng.params)
    log(f"train: llama3-1b D={cfg.hidden_size} L={cfg.num_layers} "
        f"H={cfg.num_heads}/{cfg.num_kv_heads} F={cfg.intermediate_size} "
        f"V={cfg.vocab_size}: {n / 1e9:.3f}B params (fp32 master, "
        f"{cfg.dtype} compute), built in {time.perf_counter() - t0:.1f} s")
    micro = TRAIN_CONFIG["train_micro_batch_size_per_gpu"]
    ga = TRAIN_CONFIG["gradient_accumulation_steps"]
    batch = fixed_batch(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    losses, norms, step_s = [], [], []
    reset_counts()
    with TrainReplay(torch, fa) as replay:
        replay.stage = "train"
        for _ in range(4):
            t = time.perf_counter()
            losses.append(eng.train_batch(itertools.repeat(batch)))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            norms.append(eng.get_global_grad_norm())
        t = time.perf_counter()
        losses.append(float(eng.fused_train_step(
            {"input_ids": np.concatenate([batch["input_ids"]] * ga)})))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        norms.append(eng.get_global_grad_norm())
    counts = {name: KERNELS[name].launches for name in TRAIN_KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"train: losses {losses}, grad norms {norms}, launches {counts}, "
        f"peak memory {peak_gb:.1f} GB")
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        raise AssertionError(f"train: non-finite loss or grad norm: "
                             f"{losses} {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: last loss {losses[-1]} not below the "
                             f"first {losses[0]}")
    missing = [k for k, c in counts.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched in the train phase: "
                             f"{missing} (counts {counts})")
    replay_errs = replay.check()
    log(f"train: captured launches replayed vs plain, max abs err "
        f"{replay_errs}; (max abs err, max |plain|, worst {TILE}-row tile "
        f"err / tile max |plain|) {replay.tiles} (gate {BWD_REL})")
    tokens = micro * ga * TRAIN_SEQ
    flops_per_token = 6 * n + 12 * cfg.num_layers * TRAIN_SEQ \
        * cfg.hidden_size
    steady = float(np.median(step_s[1:]))
    PHASE_NOTES["train_step_ms"] = round(steady * 1e3, 1)
    tps = tokens / steady
    log(f"train [{torch.cuda.get_device_name(0)}]: step ms "
        f"{[round(s * 1e3, 1) for s in step_s]} (4 train_batch, then "
        f"fused_train_step; the first includes warm-up), median of the "
        f"last four {steady * 1e3:.1f} ms = {tps:.1f} tokens/s "
        f"({tokens} tokens/step), model-FLOPs share "
        f"{tps * flops_per_token / BF16_FLOPS_PER_S:.4f} of 989 TFLOP/s "
        f"({flops_per_token / 1e9:.3f} GFLOP/token)")
    del eng, replay
    gc.collect()
    torch.cuda.empty_cache()
    grad_cross_check(torch, fa, batch)
    return counts


# ---------------------------------------------------------------------------
# phase 8: head dims 96 and 256 -- phi3-mini and pythia-1b served and trained
# ---------------------------------------------------------------------------

# each preset with the int pool it is served over beside its bf16 one: the
# two presets run both of A's and B's int modes at a new head dim
HEAD_DIM_PRESETS = (("phi3-mini", "int8"), ("pythia-1b", "int4"))
# layers trained at full width (None: the preset's depth): phi3-mini's fp32
# master weights and AdamW state alone take ~61 GB at its 32 layers
HEAD_DIM_TRAIN_LAYERS = {"phi3-mini": 2, "pythia-1b": None}
HEAD_DIM_TRAIN_STEPS = 3
HEAD_DIM_DENSE_PUTS = 4


def head_dim_serve(torch, pa, fa, KERNELS, reset_counts, name, int_kv):
    """``InferenceEngineV2`` on ``name`` at full width and depth (seed-0 bf16
    weights rescaled by :func:`attention_heavy`; max_seq_len 2048, 8 slots,
    block 128), once over a bf16 pool and once over ``int_kv``, each engine
    on phase 4's traffic under a :class:`Replay` of the path's first
    launches (A, B, C, D or A's and B's int modes), then freed. Gates:
    finite logits, valid tokens, every kernel of the path launched, the
    replays, and (bf16 pool) the 1100-token prompt chunked against a whole-
    prompt ``put`` at ``CROSS_PATH_REL_L2``. Returns launches per kernel."""
    from deepspeed_tpu_torch import InferenceEngineV2, TransformerLM, get_preset
    from deepspeed_tpu_torch.models.spec import num_params

    cfg = get_preset(name, param_dtype="bfloat16")
    model = TransformerLM(cfg)
    tree = serve_params(torch, cfg)
    V = cfg.vocab_size
    firsts, fresh = serve_prompts(V)
    card = torch.cuda.get_device_name(0)
    log(f"head-dims serve: {name} D={cfg.hidden_size} L={cfg.num_layers} "
        f"H={cfg.num_heads}/{cfg.num_kv_heads} d={cfg.head_dim} "
        f"F={cfg.intermediate_size} V={V} ({cfg.arch}, rope_pct "
        f"{cfg.rope_pct}, parallel block {cfg.parallel_block}): "
        f"{num_params(tree) / 1e9:.3f}B params")
    total = {}
    for kv in ("bf16", int_kv):
        free_card(torch, "cuda")
        eng = InferenceEngineV2(model, tree, max_sequences=8,
                                max_seq_len=2048, block_size=128,
                                device="cuda", kv_dtype=kv)
        tail = "" if kv == "bf16" else f"_{kv}"
        dec, past = f"paged_decode{tail}", f"paged_past{tail}"
        path = (dec, past, "chunk_self", "flash_fwd")
        torch.cuda.synchronize()
        reset_counts()
        replay = Replay(torch, pa, fa)
        replay.REQUIRED = {(dec, "put"), (past, "put"), ("chunk_self", "put"),
                           ("flash_fwd", "put"), (dec, "decode_batch")}
        with replay:
            replay.stage = "put"
            t = time.perf_counter()
            out1 = eng.put([0, 1, 2, 3], firsts)
            dt_prefill = time.perf_counter() - t
            check_logits(out1, V)
            nxt = [int(np.argmax(out1[u])) for u in range(4)]
            t = time.perf_counter()
            out2 = eng.put([0, 1, 2, 3, 4, 5],
                           [np.array([x], np.int32) for x in nxt] + fresh)
            dt_mixed = time.perf_counter() - t
            check_logits(out2, V)
            nxt = [int(np.argmax(out2[u])) for u in range(6)]
            replay.stage = "decode_batch"
            t = time.perf_counter()
            toks = eng.decode_batch(list(range(6)), nxt, steps=32)
            dt_decode = time.perf_counter() - t
        counts = {k: KERNELS[k].launches for k in path}
        for u, tk in toks.items():
            if tk.shape != (32,) or tk.min() < 0 or tk.max() >= V:
                raise AssertionError(f"head-dims {name} {kv}: uid {u}: bad "
                                     f"decoded tokens {tk}")
        missing = [k for k, c in counts.items() if c == 0]
        if missing:
            raise AssertionError(f"head-dims {name} {kv}: kernels never "
                                 f"launched: {missing} (counts {counts})")
        cross = ""
        if kv == "bf16":
            whole = eng.put([6], [fresh[1]])[6]
            rel = rel_l2(out2[5], whole)
            cross = (f"; 1100-token prompt chunked vs whole, last logits rel "
                     f"L2 {rel:.3e} (gate {CROSS_PATH_REL_L2})")
            if not rel <= CROSS_PATH_REL_L2:
                raise AssertionError(f"head-dims {name}: cross-path rel L2 "
                                     f"{rel} > {CROSS_PATH_REL_L2}")
        errs = replay.check()
        log(f"head-dims serve {name} kv_dtype={kv}: launches {counts}; "
            f"captured launches replayed vs plain, max abs err {errs}{cross}")
        n_prefill = sum(len(p) for p in firsts)
        n_mixed = 4 + sum(len(p) for p in fresh)
        log(f"head-dims serve {name} kv_dtype={kv} [{card}]: whole-prompt "
            f"prefill {n_prefill / dt_prefill:.1f} tokens/s "
            f"({dt_prefill * 1e3:.1f} ms), mixed chunked step "
            f"{n_mixed / dt_mixed:.1f} tokens/s ({dt_mixed * 1e3:.1f} ms), "
            f"decode_batch {6 * 32 / dt_decode:.1f} tokens/s (6 x 32, "
            f"{dt_decode * 1e3:.1f} ms)")
        for k, c in counts.items():
            total[k] = total.get(k, 0) + c
        del eng, replay
    del tree
    free_card(torch, "cuda")
    return total


def head_dim_dense(torch, pa, KERNELS, reset_counts, name):
    """Kernel I's engine (``packed=False``) against the packed engine at 2
    layers of ``name``'s width (seed-0 weights at the init scale): phase
    4's four prompts in one ``put``, then ``HEAD_DIM_DENSE_PUTS``
    single-token ``put`` steps fed the packed engine's argmax; every logits
    vector within ``DENSE_REL_L2`` (relative L2) of the packed engine's and
    I's first launch replayed per 64-row tile. Returns I's launches."""
    import dataclasses

    from deepspeed_tpu_torch import TransformerLM, get_preset

    cfg = dataclasses.replace(get_preset(name, param_dtype="bfloat16"),
                              num_layers=2)
    model = TransformerLM(cfg)
    tree = model.init(seed=0, device="cuda")
    firsts, _ = serve_prompts(cfg.vocab_size)
    kw = dict(max_sequences=8, max_seq_len=2048, block_size=128)
    eng = dense_engine(torch, model, tree, f"{name} packed", "cuda", **kw)
    want, feeds, _, _ = dense_traffic(eng, firsts, HEAD_DIM_DENSE_PUTS)
    del eng
    eng = dense_engine(torch, model, tree, f"{name} (a)", "cuda",
                       packed=False, **kw)
    reset_counts()
    replay = DenseReplay(torch, pa, None)
    with replay:
        replay.stage = "put"
        got, _, _, _ = dense_traffic(eng, firsts, HEAD_DIM_DENSE_PUTS, feeds)
    launches = KERNELS["paged_tile"].launches
    for outs in got:
        check_logits(outs, cfg.vocab_size)
    rel = max_rel_l2(got, want)
    errs = replay.check()
    del eng, replay, tree
    free_card(torch, "cuda")
    log(f"head-dims dense {name} at 2 layers: packed=False (kernel I, "
        f"{launches} launches) vs the packed engine, rel L2 {rel:.3e} (gate "
        f"{DENSE_REL_L2}); I's first launch replayed vs plain {errs}")
    if not rel <= DENSE_REL_L2:
        raise AssertionError(f"head-dims dense {name}: rel L2 {rel} > "
                             f"{DENSE_REL_L2}")
    if not launches:
        raise AssertionError(f"head-dims dense {name}: kernel I never "
                             f"launched")
    return {"paged_tile": launches}


def head_dim_train(torch, fa, KERNELS, reset_counts, name):
    """``initialize`` on ``name`` at full width (depth
    ``HEAD_DIM_TRAIN_LAYERS``), max_seq_len 2048, random fp32 master weights
    from seed 0, bf16 compute, phase 5's config at micro-batch 2 and GA 1:
    ``HEAD_DIM_TRAIN_STEPS`` ``train_batch`` steps on one numpy-seeded
    micro-batch [2, 2048] under a :class:`TrainReplay` of D, E and F. Gates:
    finite losses and grad norms, the last loss below the first, D, E and F
    launched, the replays; then the per-leaf gradient cross-check (kernels
    vs plain attention) at 2 layers of the same width at ``GRAD_REL_L2``.
    Returns launches per kernel."""
    import dataclasses

    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch import TransformerLM, get_preset
    from deepspeed_tpu_torch.models.spec import num_params
    from deepspeed_tpu_torch.tools.train_profile import TRAIN_CONFIG, TRAIN_SEQ

    cfg = get_preset(name, max_seq_len=TRAIN_SEQ)
    if HEAD_DIM_TRAIN_LAYERS[name]:
        cfg = dataclasses.replace(cfg, num_layers=HEAD_DIM_TRAIN_LAYERS[name])
    micro = 2
    eng, *_ = tds.initialize(TransformerLM(cfg), dict(
        TRAIN_CONFIG, train_micro_batch_size_per_gpu=micro,
        gradient_accumulation_steps=1))
    batch = {"input_ids": np.random.default_rng(0).integers(
        0, cfg.vocab_size, (micro, TRAIN_SEQ)).astype(np.int32)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, step_s = [], [], []
    reset_counts()
    with TrainReplay(torch, fa) as replay:
        replay.stage = "train"
        for _ in range(HEAD_DIM_TRAIN_STEPS):
            t = time.perf_counter()
            losses.append(eng.train_batch(itertools.repeat(batch)))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            norms.append(eng.get_global_grad_norm())
    counts = {k: KERNELS[k].launches for k in TRAIN_KERNELS}
    peak = torch.cuda.max_memory_allocated() / 1e9
    n = num_params(eng.params)
    log(f"head-dims train {name} D={cfg.hidden_size} L={cfg.num_layers} "
        f"H={cfg.num_heads}/{cfg.num_kv_heads} d={cfg.head_dim}: "
        f"{n / 1e9:.3f}B params, losses {losses}, grad norms {norms}, "
        f"launches {counts}, peak memory {peak:.1f} GB, step ms "
        f"{[round(x * 1e3, 1) for x in step_s]} "
        f"[{torch.cuda.get_device_name(0)}]")
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        raise AssertionError(f"head-dims train {name}: non-finite loss or "
                             f"grad norm: {losses} {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"head-dims train {name}: last loss "
                             f"{losses[-1]} not below the first {losses[0]}")
    missing = [k for k, c in counts.items() if c == 0]
    if missing:
        raise AssertionError(f"head-dims train {name}: kernels never "
                             f"launched: {missing} (counts {counts})")
    errs = replay.check()
    log(f"head-dims train {name}: captured launches replayed vs plain, max "
        f"abs err {errs}; (max abs err, max |plain|, worst {TILE}-row tile "
        f"err / tile max |plain|) {replay.tiles} (gate {BWD_REL})")
    del eng, replay
    free_card(torch, "cuda")
    model = TransformerLM(dataclasses.replace(cfg, num_layers=2))
    params = model.init(seed=0, device="cuda")
    ids = {"input_ids": torch.from_numpy(batch["input_ids"]).cuda()}
    rel = grad_rel_l2(torch, fa, model, params, ids)
    del params
    free_card(torch, "cuda")
    log(f"head-dims train {name}: gradient cross-check at 2 layers, kernels "
        f"vs plain attention, rel L2 {rel} (gate {GRAD_REL_L2})")
    bad = {k: r for k, r in rel.items() if not r <= GRAD_REL_L2}
    if bad:
        raise AssertionError(f"head-dims train {name}: gradient cross-check "
                             f"rel L2 {bad} > {GRAD_REL_L2}")
    return counts


def head_dims(torch, pa, fa, KERNELS, reset_counts):
    """Phase 8: each of ``HEAD_DIM_PRESETS`` served (:func:`head_dim_serve`),
    its dense-tile engine checked (:func:`head_dim_dense`) and trained
    (:func:`head_dim_train`). Every attention kernel runs here at d = 96
    or d = 256 and must launch. Returns the phase's launches per kernel."""
    total = {}
    for name, int_kv in HEAD_DIM_PRESETS:
        for counts in (
                head_dim_serve(torch, pa, fa, KERNELS, reset_counts, name,
                               int_kv),
                head_dim_dense(torch, pa, KERNELS, reset_counts, name),
                head_dim_train(torch, fa, KERNELS, reset_counts, name)):
            for k, c in counts.items():
                total[k] = total.get(k, 0) + c
    want = {"paged_decode", "paged_decode_int8", "paged_decode_int4",
            "paged_past", "paged_past_int8", "paged_past_int4", "chunk_self",
            "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "paged_tile"}
    missing = sorted(k for k in want if not total.get(k))
    if missing:
        raise AssertionError(f"head-dims: kernels never launched {missing}")
    log(f"head-dims: launches {total}")
    return total


# ---------------------------------------------------------------------------
# phase 9: the engine's serving features on llama3-8b
# ---------------------------------------------------------------------------

FEATURE_KERNELS = ("paged_decode", "paged_past", "chunk_self", "flash_fwd")
FEATURE_PREFIX = 1024          # tokens of the shared prefix: 8 full blocks
FEATURE_MAX_SEQ = 2048         # max_seq_len of every phase 9 engine
FEATURE_SUFFIXES = (37, 128, 129, 300)
FEATURE_STEPS = 16             # decode_batch steps of (a) and (e)
SPEC_STEPS = 32
PAUSE_CALLS = (8, 8, 8)        # decode_batch steps of (d)'s three calls
TIER_HOST_BLOCKS = 3           # host budget of (b): 48 MB at llama3-8b
SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.9)
# (c): where speculative and fused tokens part, a token passes when its
# teacher-forced logit lies at most this many standard deviations of the
# logits below the argmax. The two paths' bf16 GEMM rows differ, so a near
# tie can flip: on the H100 the token off the argmax read 0.0488 and 0.0244
# sd (PERF.md, PR 15), 5x and 10x below the gate, every later token 0; the
# largest of 128256 normal logits lies some 4.4 sd above their mean, so a
# token drawn at random fails by far.
SPEC_GAP_SD = 0.25


class FeatureReplay(Replay):
    """Phase 9's :class:`Replay`: D's first launch in the cold prompt put
    (stage ``cold``), B's and C's in the warm (prefix-attached) put
    (``warm``) and in the first speculative verify step (``spec``: 32-row
    atoms of 2-5 tokens at unaligned positions), A's first launch past
    the pool frontier in ``decode_batch``."""

    REQUIRED = {("flash_fwd", "cold"), ("paged_past", "warm"),
                ("chunk_self", "warm"), ("paged_past", "spec"),
                ("chunk_self", "spec"), ("paged_decode", "decode_batch")}

    def _wanted(self, target, name, x) -> bool:
        return self.stage is not None and super()._wanted(target, name, x)


def feature_traffic(V):
    """Phase 9's prompts (numpy seed 9): the 1024-token shared prefix with
    the four suffixes, four prompts that repeat (a random 23-token phrase
    eight times over), and four short prompts (41, 96, 130, 257 tokens)
    for pause/resume and sampling."""
    rng = np.random.default_rng(9)
    prefix = rng.integers(1, V, FEATURE_PREFIX).astype(np.int32)
    shared = [np.concatenate([prefix, rng.integers(1, V, n).astype(np.int32)])
              for n in FEATURE_SUFFIXES]
    repeat = [np.tile(rng.integers(1, V, 23).astype(np.int32), 8)
              for _ in range(4)]
    short = [rng.integers(1, V, n).astype(np.int32) for n in (41, 96, 130, 257)]
    return shared, repeat, short


def cold_then_warm(eng, prompts, uids, V, **sampling):
    """The first prompt alone, then the other three in one put (on a prefix
    cache engine the three attach the first's published prefix), then
    ``decode_batch(FEATURE_STEPS)`` over all four from their argmax.
    Returns (last-token logits per uid, tokens per uid)."""
    out = dict(eng.put(uids[:1], prompts[:1]))
    out.update(eng.put(uids[1:], prompts[1:]))
    check_logits(out, V)
    toks = eng.decode_batch(uids, [int(np.argmax(out[u])) for u in uids],
                            steps=FEATURE_STEPS, **sampling)
    return out, toks


def pool_blocks(torch, eng, blocks):
    idx = torch.as_tensor(blocks, device=eng.device)
    return {n: t.index_select(1, idx).clone() for n, t in eng.cache.items()}


def paused_run(eng, prompts, uids, pause=None, migrate=None):
    """``put`` of ``prompts`` then ``decode_batch`` over ``uids`` for each
    of ``PAUSE_CALLS``, feeding each call its last tokens. ``pause=uid``
    pauses and resumes that uid between the first and second call;
    ``migrate=(fn)`` instead pauses it and hands it to ``fn(uid, tok)``,
    which returns its remaining tokens from another engine. Returns the
    tokens per uid, concatenated over the calls."""
    out = eng.put(uids, prompts)
    cur = {u: int(np.argmax(out[u])) for u in uids}
    got = {u: [] for u in uids}
    live = list(uids)
    for i, steps in enumerate(PAUSE_CALLS):
        if i == 1 and pause is not None:
            if not eng.pause_request(pause):
                raise AssertionError(f"pause_request({pause}) refused")
            if not eng.resume_request(pause):
                raise AssertionError(f"resume_request({pause}) refused")
        if i == 1 and migrate is not None:
            uid, fn = migrate
            if not eng.pause_request(uid):
                raise AssertionError(f"pause_request({uid}) refused")
            got[uid] += fn(uid, cur[uid])
            live.remove(uid)
        res = eng.decode_batch(live, [cur[u] for u in live], steps=steps)
        for u in live:
            got[u] += [int(t) for t in res[u]]
            cur[u] = got[u][-1]
    eng.flush(list(uids))
    return got


def teacher_forced_logits(eng, prompt, t0, toks, first, uid=990) -> list:
    """The logits before each of ``toks[first:]`` under teacher forcing: a
    ``put`` of the prompt, ``t0`` and ``toks[:first]``, then a ``put`` of
    each next token in turn."""
    feed = np.concatenate([prompt, [t0], np.asarray(toks[:first])])
    out = [eng.put([uid], [feed.astype(np.int32)])[uid]]
    for tok in toks[first:-1]:
        out.append(eng.put([uid], [np.asarray([tok], np.int32)])[uid])
    eng.flush([uid])
    return out


def sd_gap(lg, tok) -> float:
    """How far token ``tok``'s logit lies below the largest logit, in
    standard deviations of the logits."""
    return (float(lg.max()) - float(lg[tok])) / float(lg.std())


def spec_matches(tag, eng, prompt, t0, plain, spec) -> None:
    """Speculative tokens ``spec`` against the fused loop's ``plain``.
    Where they part (step ``s``), teacher-forced logits
    (:func:`teacher_forced_logits`) must put the fused token at ``s`` and
    every speculative token from ``s`` on within ``SPEC_GAP_SD`` standard
    deviations of the logits below the argmax; printed with the step."""
    n = min(len(plain), len(spec))
    diff = np.nonzero(np.asarray(plain[:n]) != np.asarray(spec[:n]))[0]
    if not diff.size:
        return
    s = int(diff[0])
    logits = teacher_forced_logits(eng, prompt, t0, spec, s)
    fused = sd_gap(logits[0], plain[s])
    gaps = [sd_gap(lg, t) for lg, t in zip(logits, spec[s:])]
    w = int(np.argmax(gaps))
    log(f"serve-features (c) speculative {tag}: parts from the fused loop "
        f"at step {s}; teacher-forced gap below the argmax, in sd of the "
        f"logits: fused token {fused:.3e}, speculative token {gaps[0]:.3e}; "
        f"largest over the {len(gaps)} speculative tokens from step {s} on "
        f"{gaps[w]:.3e} at step {s + w} (gate {SPEC_GAP_SD})")
    if not (fused <= SPEC_GAP_SD and gaps[w] <= SPEC_GAP_SD):
        raise AssertionError(f"speculative {tag}: tokens part at step {s}; "
                             f"fused token {fused:.3e} sd, speculative token "
                             f"at step {s + w} {gaps[w]:.3e} sd below the "
                             f"argmax")


def serve_features(torch, pa, fa, KERNELS, reset_counts, name="llama3-8b",
                   device="cuda", fingerprint=None, **overrides):
    """Phase 9 on ``name`` (llama3-8b at full width and depth on the card)
    over phase 4's bf16 weights, rebuilt from seed 0 by
    :func:`serve_params` (phase 4's engine was freed) and held equal to
    phase 4's tree by ``fingerprint`` (:func:`tree_fingerprint`) where one
    is given; this one tree is shared by every engine, copied by none. (a)
    prefix cache warm vs cold, (b) demote to host and NVMe and promote,
    (c) speculative vs fused greedy decode, (d) pause/resume and
    export/adopt (bf16 and int8 pools), (e) sampled decode. ``device`` and
    preset ``overrides`` let the CPU tests drive it at a tiny width.
    Returns the phase's launches per kernel and what phase 10 reuses: the
    model, the tree, (a)'s warm greedy tokens and the tier host budget."""
    import shutil
    import tempfile

    from deepspeed_tpu_torch import InferenceEngineV2, TransformerLM, get_preset
    from deepspeed_tpu_torch.inference.kv_tier import (claim_manifest,
                                                       load_manifest)

    cfg = get_preset(name, **{"param_dtype": "bfloat16", **overrides})
    model = TransformerLM(cfg)
    tree = serve_params(torch, cfg, device)
    if fingerprint is not None:
        mine = tree_fingerprint(torch, tree)
        if len(mine) != len(fingerprint) or not all(
                torch.equal(a, b) for a, b in zip(mine, fingerprint)):
            raise AssertionError("serve-features: the rebuilt tree is not "
                                 "phase 4's")
        log(f"serve-features: rebuilt tree equals phase 4's ({len(mine)} "
            f"leaves, every 1009th element)")
    V = cfg.vocab_size
    card = torch.cuda.get_device_name(0) if device == "cuda" else device
    shared, repeat, short = feature_traffic(V)
    tmp = tempfile.mkdtemp(prefix="dstpu_kv_tier_")
    itemsize = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    host_mb = (TIER_HOST_BLOCKS * 2 * cfg.num_layers * 128 * cfg.num_kv_heads
               * cfg.head_dim * itemsize / 2**20)

    def engine(tag, **kw):
        eng = InferenceEngineV2(model, tree, max_sequences=8,
                                max_seq_len=FEATURE_MAX_SEQ, block_size=128,
                                device=device, **kw)
        owns_no_copy(tree, eng.params, tag)
        return eng

    try:
        free_card(torch, device)
        cold = engine("cold")
        warm = engine("warm", speculative={"enabled": False},
                      prefix_cache={"enabled": True, "tiers": {
                          "enabled": True, "host_mb": host_mb,
                          "nvme_path": os.path.join(tmp, "nvme")}})
        free_card(torch, device)
        reset_counts()
        replay = FeatureReplay(torch, pa, fa)
        with replay:
            # ---- (a) prefix cache: warm against cold
            replay.stage = "cold"
            c_out, c_toks = cold_then_warm(cold, shared, [0, 1, 2, 3], V)
            w_out = dict(warm.put([0], shared[:1]))
            replay.stage = "warm"
            hit0 = warm.prefix_cache.counters["hit_tokens"]
            b0 = KERNELS["paged_past"].launches
            w_out.update(warm.put([1, 2, 3], shared[1:]))
            b_warm = KERNELS["paged_past"].launches - b0
            hits = warm.prefix_cache.counters["hit_tokens"] - hit0
            check_logits(w_out, V)
            replay.stage = "decode_batch"
            w_toks = warm.decode_batch(
                [0, 1, 2, 3], [int(np.argmax(w_out[u])) for u in range(4)],
                steps=FEATURE_STEPS)
            replay.stage = None
            rels = {u: rel_l2(w_out[u], c_out[u]) for u in range(4)}
            log(f"serve-features (a) prefix: warm puts hit {hits} tokens "
                f"({hits // 3} per request), kernel B launches in the warm "
                f"put {b_warm}; last-token logits warm vs cold rel L2 "
                f"{ {u: f'{r:.3e}' for u, r in rels.items()} } (gate "
                f"{CROSS_PATH_REL_L2})")
            if hits != 3 * FEATURE_PREFIX or (device == "cuda"
                                               and b_warm == 0):
                raise AssertionError(f"prefix: hit tokens {hits} (want "
                                     f"{3 * FEATURE_PREFIX}), B launches "
                                     f"{b_warm}")
            if not max(rels.values()) <= CROSS_PATH_REL_L2:
                raise AssertionError(f"prefix: warm vs cold rel L2 {rels}")
            for u in range(4):
                if not np.array_equal(w_toks[u], c_toks[u]):
                    raise AssertionError(f"prefix: uid {u} greedy tokens "
                                         f"warm {w_toks[u]} cold {c_toks[u]}")
            log("serve-features (a) prefix: greedy tokens warm == cold for "
                f"all four requests ({FEATURE_STEPS} steps)")
            warm.flush([0, 1, 2, 3])

            # ---- (b) tiers: demote to host and NVMe, then promote
            prompt = shared[1]
            ref = warm.put([20], [prompt])[20]
            blocks = warm.state.sequences[20].blocks[:FEATURE_PREFIX // 128]
            before = pool_blocks(torch, warm, blocks)
            warm.flush([20])
            pc = warm.prefix_cache
            n_ev = pc.evictable_blocks()
            free_card(torch, device)
            t = time.perf_counter()
            pc.evict(n_ev)
            dt_demote = time.perf_counter() - t
            rep = pc.report()
            tiers = rep["tiers"]
            log(f"serve-features (b) tiers: demoted {n_ev} blocks "
                f"({tiers['host_entries']} host, {tiers['nvme_entries']} "
                f"NVMe; host budget {host_mb:.1f} MB) in "
                f"{dt_demote * 1e3:.1f} ms ({dt_demote * 1e3 / n_ev:.2f} "
                f"ms/block)")
            if rep["blocks"] != 0 or not tiers["nvme_entries"] \
                    or not tiers["host_entries"]:
                raise AssertionError(f"tiers: demote left {rep}")
            n = warm.prefix_attach(21, prompt)
            n_prom = len(warm._promote_q)
            t = time.perf_counter()
            warm._flush_promotes()
            if device == "cuda":
                torch.cuda.synchronize()
            dt_promote = time.perf_counter() - t
            after = pool_blocks(torch, warm,
                                warm.state.sequences[21].blocks[:len(blocks)])
            exact = all(torch.equal(before[k], after[k]) for k in before)
            got = warm.put([21], [prompt[n:]])[21]
            rep = warm.tier_report()
            log(f"serve-features (b) tiers: attach of {n} tokens promoted "
                f"{n_prom} blocks ({rep['host_hits']} host, "
                f"{rep['nvme_hits']} NVMe hits, {rep['batched_reads']} "
                f"batched NVMe read) in {dt_promote * 1e3:.1f} ms "
                f"({dt_promote * 1e3 / max(n_prom, 1):.2f} ms/block); "
                f"promoted blocks == pre-demote bytes: {exact}; logits "
                f"bit-identical to the warm attach before the demote: "
                f"{np.array_equal(got, ref)}")
            if n != FEATURE_PREFIX or n_prom != len(blocks) or not exact \
                    or not np.array_equal(got, ref):
                raise AssertionError("tiers: promote round trip not exact")
            warm.flush([21])

            # ---- (c) speculative against fused greedy decode
            ids = (30, 31, 32, 33)
            out = warm.put(list(ids), repeat)
            t0 = [int(np.argmax(out[u])) for u in ids]
            plain = warm.decode_batch(list(ids), t0, steps=SPEC_STEPS,
                                      speculative=False)
            warm.flush(list(ids))
            warm.prefix_cache.clear()       # the spec run prefills cold too
            warm.put(list(ids), repeat)
            s0 = dict(warm.spec_stats)
            replay.stage = "spec"
            spec = warm.decode_batch(list(ids), t0, steps=SPEC_STEPS,
                                     speculative=True)
            st = {k: warm.spec_stats[k] - s0[k] for k in s0}
            warm.flush(list(ids))
            warm.prefix_cache.clear()
            log(f"serve-features (c) speculative decode_batch: "
                f"{st['rounds']} verify rounds, {st['drafted']} drafted, "
                f"{st['accepted']} accepted, {st['emitted']} emitted, "
                f"{st['fallback_steps']} fused fallback steps "
                f"({len(ids) * SPEC_STEPS} tokens)")
            for i, u in enumerate(ids):
                spec_matches(f"prompt {i}", warm, repeat[i], t0[i],
                             plain[u], spec[u])
            # one round verifying the fused loop's own next four tokens as
            # drafts: 5-token atoms at position 184 of each sequence
            warm.put(list(ids), repeat)
            res, info = warm.spec_decode_round(
                list(ids), t0, drafts=[plain[u][:4] for u in ids])
            replay.stage = None
            warm.flush(list(ids))
            log(f"serve-features (c) speculative round on the fused "
                f"loop's tokens as drafts: {info['drafted']} drafted, "
                f"{info['accepted']} accepted, {info['emitted']} emitted")
            for i, u in enumerate(ids):
                spec_matches(f"round, prompt {i}", warm, repeat[i], t0[i],
                             plain[u], res[u])
            log("serve-features (c) speculative: tokens checked against "
                "the fused loop for all four prompts")

            # ---- (e) sampling
            ids = [40, 41, 42, 43]
            draws = {}
            for tag, seed in (("a", 7), ("b", 7), ("c", 8)):
                out = cold.put(ids, short)
                draws[tag] = cold.decode_batch(
                    ids, [int(np.argmax(out[u])) for u in ids],
                    steps=FEATURE_STEPS, seed=seed, **SAMPLING)
                cold.flush(ids)
            same = all(np.array_equal(draws["a"][u], draws["b"][u])
                       for u in ids)
            differ = any(not np.array_equal(draws["a"][u], draws["c"][u])
                         for u in ids)
            cold.flush([0, 1, 2, 3])
            _, g_toks = cold_then_warm(cold, shared, [0, 1, 2, 3], V,
                                       temperature=0.0, seed=7)
            greedy = all(np.array_equal(g_toks[u], c_toks[u])
                         for u in range(4))
            cold.flush([0, 1, 2, 3])
            log(f"serve-features (e) sampling {SAMPLING}: seed 7 twice "
                f"identical {same}, seed 8 differs {differ}; temperature=0 "
                f"decode == (a)'s greedy tokens {greedy}")
            if not (same and differ and greedy):
                raise AssertionError("sampling: reproducibility gates")
            warm.close()
            del warm
            free_card(torch, device)
            # ---- (d) pause/resume and export/adopt (bf16), pause/resume
            # int8 (no captures: the replays above cover the kernels)
            uids = [50, 51, 52, 53]
            ref = paused_run(cold, short, uids)
            got = paused_run(cold, short, uids, pause=52)
            rep = cold.tier_report()
            log(f"serve-features (d) pause/resume bf16: uid 52 paused and "
                f"resumed between decode calls; tokens identical "
                f"{got[52] == ref[52]} (others {all(got[u] == ref[u] for u in uids)}"
                f"); store {rep['host_demotions']} demotions, "
                f"{rep['host_hits']} hits, {rep['paused_requests']} paused")
            if got != ref:
                raise AssertionError(f"pause/resume bf16: tokens part {got} vs "
                                     f"{ref}")
            mig = os.path.join(tmp, "migrate")
            cold.migration_nvme_path = mig
            other = engine("adopter")
            other.migration_nvme_path = mig

            def hand_over(uid, tok):
                path = cold.export_paused(uid, f"x-{uid}", mig, keep=False)
                claimed = claim_manifest(path)
                cold.flush([uid])
                other.adopt_paused(900, load_manifest(claimed),
                                   manifest_path=claimed)
                if not other.resume_request(900):
                    raise AssertionError("adopter: resume_request refused")
                toks = []
                for steps in PAUSE_CALLS[1:]:
                    res = other.decode_batch([900], [tok], steps=steps)[900]
                    toks += [int(t) for t in res]
                    tok = toks[-1]
                other.flush([900])
                return toks

            got = paused_run(cold, short, uids, migrate=(52, hand_over))
            log(f"serve-features (d) migrate bf16: uid 52 exported after the "
                f"first call and adopted by a second engine on the same tree; "
                f"tokens identical {got[52] == ref[52]}; adopter store "
                f"{other.tier_report()['durable_adopts']} durable adopts")
            if got != ref:
                raise AssertionError(f"migrate: tokens part {got[52]} vs "
                                     f"{ref[52]}")
            other.close()
            cold.close()
            del other, cold
            free_card(torch, device)
            q = engine("int8", kv_dtype="int8")
            ref = paused_run(q, short, uids)
            got = paused_run(q, short, uids, pause=52)
            parts = sorted(q._extract_blocks([0])[0])
            log(f"serve-features (d) pause/resume int8 pool (tier parts "
                f"{parts}): tokens identical {got == ref}")
            if got != ref:
                raise AssertionError("pause/resume int8: tokens part")
            q.close()
            del q
        counts = {k: v.launches for k, v in KERNELS.items() if v.launches}
        missing = [k for k in FEATURE_KERNELS if not counts.get(k)]
        if missing:
            raise AssertionError(f"serve-features: kernels never launched "
                                 f"{missing} (counts {counts})")
        errs = replay.check()
        log(f"serve-features: launches {counts}; captured launches replayed "
            f"vs plain, max abs err {errs}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    free_card(torch, device)
    log(f"serve-features [{card}]: done")
    return counts, dict(model=model, tree=tree, greedy=w_toks,
                        host_mb=host_mb)


# ---------------------------------------------------------------------------
# phase 10: observability -- the engine's instruments on llama3-8b
# ---------------------------------------------------------------------------

OBS_KERNEL = "paged_decode_kernel"     # kernel A's symbol in a profile
OBS_STEP_UIDS = (0, 1, 2)              # requests of the launch count
OBS_CAPTURES = 3                       # trigger captures, at most


def step_launches(torch, fn, traces: int = 2) -> list:
    """Kernels the card ran for each of ``traces`` calls of ``fn``, counted
    from ``torch.profiler`` as ``tools/serve_profile.py`` counts a step's
    launches (every device row with device time, its calls)."""
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch.tools.serve_profile import _device_events

    counts = []
    for _ in range(traces):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(r[2] for r in _device_events(prof)))
    return counts


def host_ms_line(reg, timing) -> str:
    """p50 / p90 of the engine's ``inference/*`` histograms, and of the
    puts' dispatch split, in ms."""
    parts = []
    for name in ("put_host_ms", "put_fetch_ms", "decode_fetch_ms"):
        h = reg.histogram(f"inference/{name}")
        parts.append(f"{name} p50 {h.percentile(50):.3f} p90 "
                     f"{h.percentile(90):.3f} (n={h.count})")
    disp = [t["dispatch_ms"] for t in timing if t]
    if disp:
        parts.append(f"put dispatch_ms p50 {np.percentile(disp, 50):.3f} "
                     f"p90 {np.percentile(disp, 90):.3f} (n={len(disp)})")
    return "; ".join(parts)


def capture_trace(torch, eng, uids, cur, root, device) -> tuple:
    """A :class:`ProfileTrigger` armed through its trigger file (warm-up 1,
    2 capture steps, default ``torch.profiler`` start/stop), ``check``
    called after each ``decode_batch(steps=2)`` of ``uids``. The profiler
    now and then hands a trace no device records at all (see
    :func:`device_launches`): such a capture is taken again
    (``OBS_CAPTURES`` at most); a control kernel (``spin_kernel``) before
    and after each captured call is counted in the log. Returns (the
    trace's event names, the tokens fed next, captures taken)."""
    from deepspeed_tpu_torch.observability import ProfileTrigger
    from deepspeed_tpu_torch.observability.profiler import TRACE_FILE

    for n in range(1, OBS_CAPTURES + 1):
        trig = ProfileTrigger(os.path.join(root, f"attempt{n}"),
                              capture_steps=2, warmup_steps=1,
                              rate_limit_s=0.0)
        os.makedirs(trig.output_dir, exist_ok=True)
        open(trig.trigger_file, "w").close()
        cap, step = None, 0
        while cap is None and step < 6:
            step += 1
            live = trig.capturing and device == "cuda"
            if live:
                torch.cuda._sleep(1000)
            res = eng.decode_batch(list(uids), [cur[u] for u in uids],
                                   steps=2)
            cur = {u: int(res[u][-1]) for u in uids}
            if live:
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
            cap = trig.check(step)
        trig.close()
        if cap is None or os.path.exists(trig.trigger_file):
            raise AssertionError(f"profile trigger: no capture "
                                 f"({trig.report()})")
        with open(os.path.join(cap, TRACE_FILE)) as f:
            events = json.load(f)["traceEvents"]
        names = [e.get("name", "") for e in events]
        kernels = sum(e.get("cat") == "kernel" for e in events)
        spins = sum("spin_kernel" in x for x in names)
        log(f"observability: capture {n}: {kernels} kernel records, {spins} "
            f"of the 4 control kernels")
        if device != "cuda" or kernels:
            return names, cur, n
    raise AssertionError(f"the profiler delivered no kernel record in "
                         f"{OBS_CAPTURES} captures")


def observability(torch, KERNELS, reset_counts, model, tree, greedy,
                  host_mb, device="cuda"):
    """Phase 10 on phase 9's model and tree (no new tree, no copy): a
    prefix-cache engine with tiers on (phase 9's settings) built after a
    fresh process registry (``set_registry(None)``) and with tracing on,
    ``enable_metrics()``. Phase 9 (a)'s traffic, then launches per decode
    step with the hooks on and off, a profile capture armed through its
    trigger file, a resume failed by an injected fault, a demote and
    promote of the cache, a clean pause/resume, a flight dump. Gates: see
    the module docstring. Returns the phase's launches per kernel."""
    import shutil
    import tempfile

    from deepspeed_tpu_torch import InferenceEngineV2
    from deepspeed_tpu_torch.observability import (configure_tracing,
                                                   flight_dump, get_registry,
                                                   set_registry, trace_export,
                                                   validate_trace)
    from deepspeed_tpu_torch.resilience import (FaultInjector, FaultSpec,
                                                set_injector)

    cfg = model.cfg
    V = cfg.vocab_size
    card = card_line() if device == "cuda" else device
    shared, _, short = feature_traffic(V)
    tmp = tempfile.mkdtemp(prefix="dstpu_obs_")
    uids = [0, 1, 2, 3]
    reg = set_registry(None)
    set_injector(None)
    dumps = os.path.join(tmp, "flight")
    bus = configure_tracing(enabled=True, ring_size=1 << 16, sample=1,
                            dump_dir=dumps)
    bus.clear()
    timing = []
    try:
        free_card(torch, device)
        eng = InferenceEngineV2(
            model, tree, max_sequences=8, max_seq_len=FEATURE_MAX_SEQ,
            block_size=128, device=device, speculative={"enabled": False},
            prefix_cache={"enabled": True, "tiers": {
                "enabled": True, "host_mb": host_mb,
                "nvme_path": os.path.join(tmp, "nvme")}})
        owns_no_copy(tree, eng.params, "observability")
        eng.enable_metrics()
        reset_counts()
        # ---- phase 9 (a)'s traffic with the hooks on
        out = dict(eng.put(uids[:1], shared[:1]))
        timing.append(eng.timing)
        out.update(eng.put(uids[1:], shared[1:]))
        timing.append(eng.timing)
        toks = eng.decode_batch(uids, [int(np.argmax(out[u])) for u in uids],
                                steps=FEATURE_STEPS)
        same = all(np.array_equal(toks[u], greedy[u]) for u in uids)
        log(f"observability: greedy tokens with the hooks on == phase 9 "
            f"(a)'s with them off: {same} ({len(uids)} x {FEATURE_STEPS})")
        if not same:
            raise AssertionError("observability: the hooks changed the "
                                 "greedy tokens")

        def value(name, **labels):
            return reg.counter(name, labels=labels or None).value

        want = {"inference/tokens": sum(len(p) for p in shared)
                - 3 * FEATURE_PREFIX,
                "inference/decode_tokens": len(uids) * FEATURE_STEPS,
                "inference/prefix_cache_hit_tokens": 3 * FEATURE_PREFIX,
                "inference/prefix_cache_hits": 3,
                "inference/decode_dispatches": 1}
        got = {k: value(k) for k in want}
        log(f"observability: registry after (a) {got} (want {want}; "
            f"inference/tokens counts what put() ran through the model: "
            f"the prompts' tokens less the {3 * FEATURE_PREFIX} prefix hits)")
        if got != want:
            raise AssertionError(f"observability: registry {got} != {want}")

        # ---- launches per bf16 decode step, hooks on and off
        cur = {u: int(toks[u][-1]) for u in uids}

        def step():
            res = eng.put(uids, [np.asarray([cur[u]], np.int32)
                                 for u in uids])
            timing.append(eng.timing)
            cur.update({u: int(np.argmax(res[u])) for u in uids})

        if device == "cuda":
            # three traces each, on and off in turn, read by their medians:
            # the profiler has both dropped a record and added ten in one
            # trace of a run (with the hooks on and with them off), which
            # moves one count; a launch the hooks add moves every count of
            # theirs
            obs_on, on, off = eng._obs, [], []
            for _ in range(3):
                on += step_launches(torch, step, traces=1)
                configure_tracing(enabled=False)
                eng._obs = None
                off += step_launches(torch, step, traces=1)
                configure_tracing(enabled=True, dump_dir=dumps)
                eng._obs = obs_on
            log(f"observability: device launches per decode step (4 "
                f"sequences, put; profiler, as serve_profile counts) hooks "
                f"on {on}, off {off}")
            if sorted(on)[1] != sorted(off)[1] or not min(on):
                raise AssertionError(f"observability: launches differ with "
                                     f"the hooks ({on} vs {off})")
        else:
            step()

        # ---- the profile trigger's capture (after the launch count:
        # profiler sessions do not nest)
        names, cur, tries = capture_trace(torch, eng, uids, cur,
                                          os.path.join(tmp, "profiles"),
                                          device)
        hits = sum(OBS_KERNEL in x for x in names)
        log(f"observability: trigger-file capture (warm-up 1, 2 steps, "
            f"capture {tries}): {len(names)} trace events, {hits} of "
            f"kernel A ({OBS_KERNEL})")
        if device == "cuda" and not hits:
            raise AssertionError(f"observability: the capture does not "
                                 f"name {OBS_KERNEL}")
        if not names:
            raise AssertionError("observability: empty capture")

        # ---- a resume failed on its NVMe read unwinds
        pause_uid = 3
        if not eng.pause_request(pause_uid):
            raise AssertionError("observability: pause_request refused")
        nb = eng.paused_blocks(pause_uid)
        inj = set_injector(FaultInjector([FaultSpec(kind="resume_io_error",
                                                    site="nvme")]))
        try:
            resumed = eng.resume_request(pause_uid)
            failed = eng.flush_resumes()
        finally:
            set_injector(None)
        log(f"observability: resume of {nb} paused blocks with "
            f"resume_io_error pinned to nvme: resume_request {resumed}, "
            f"failed {failed}, fired {inj.fired}, uid live "
            f"{pause_uid in eng.state.sequences}")
        if failed != [pause_uid] or inj.fired != [
                "resume_io_error@resume:nvme:step=-1"] \
                or pause_uid in eng.state.sequences \
                or eng.is_paused(pause_uid):
            raise AssertionError("observability: the faulted resume did not "
                                 "unwind")
        eng.flush(uids[:pause_uid])

        # ---- demote every cache block, promote the prefix back
        pc = eng.prefix_cache
        n_ev = pc.evictable_blocks()
        pc.evict(n_ev)
        n = eng.prefix_attach(20, shared[1])
        n_prom = len(eng._promote_q)
        eng._flush_promotes()
        eng.put([20], [shared[1][n:]])
        timing.append(eng.timing)
        eng.flush([20])
        store = eng._tier_store.counters
        dem = {t: value("inference/prefix_cache_tier_demotions", tier=t)
               for t in ("host", "nvme")}
        prom = sum(reg.histogram("inference/prefix_cache_tier_promote_ms",
                                 labels={"tier": t}).count
                   for t in ("host", "nvme"))
        log(f"observability: demoted {n_ev} cache blocks after pausing {nb}:"
            f" tier demotions {dem} (store {store['host_demotions']} host, "
            f"{store['nvme_demotions']} NVMe); promoted {n_prom} blocks, "
            f"promote_ms count {prom}")
        if dem != {"host": n_ev + nb, "nvme": store["nvme_demotions"]} \
                or not dem["nvme"] or prom != n_prom \
                or n_prom != FEATURE_PREFIX // 128:
            raise AssertionError("observability: tier counters disagree "
                                 "with the demotes and promotes")

        # ---- a clean resume gives the unpaused run's tokens
        ids = [50, 51, 52, 53]
        pc.clear()
        ref = paused_run(eng, short, ids)
        pc.clear()
        got = paused_run(eng, short, ids, pause=52)
        log(f"observability: pause/resume without a fault: tokens == the "
            f"unpaused run's {got == ref}")
        if got != ref:
            raise AssertionError("observability: resumed tokens differ")
        pc.clear()
        leaked = eng.state.allocator.leaked_blocks()
        if leaked:
            raise AssertionError(f"observability: leaked blocks {leaked}")
        eng.close()         # reaps the swapper's last tickets (their ends)

        # ---- the trace and the flight recorder
        doc = trace_export(bus)
        errors = validate_trace(doc)
        synthetic = sum(1 for e in doc["traceEvents"]
                        if e.get("args", {}).get("synthetic_end"))
        kinds = {}
        for e in doc["traceEvents"]:
            key = f"{e['cat']}/{e['name']}"
            kinds[key] = kinds.get(key, 0) + 1
        log(f"observability: trace {len(doc['traceEvents'])} events, "
            f"validate_trace errors {errors[:3]}, repaired ends {synthetic};"
            f" {dict(sorted(kinds.items()))}")
        if errors or synthetic:
            raise AssertionError("observability: the trace is not valid "
                                 "and balanced")
        path = flight_dump("chip_smoke", extra={"phase": 10})
        with open(path) as f:
            dumped = json.load(f)
        n_dump = len(dumped["trace"]["traceEvents"])
        log(f"observability: flight dump {os.path.basename(path)} reads "
            f"back {n_dump} events")
        if not path.startswith(tmp) or n_dump != len(doc["traceEvents"]):
            raise AssertionError("observability: flight dump")
        log(f"observability host ms per engine call [{card}]: "
            f"{host_ms_line(reg, timing)}")
        del eng
        counts = {k: v.launches for k, v in KERNELS.items() if v.launches}
    finally:
        configure_tracing(enabled=False)
        bus.clear()
        set_injector(None)
        shutil.rmtree(tmp, ignore_errors=True)
    free_card(torch, device)
    log(f"observability [{card}]: done")
    return counts


# ---------------------------------------------------------------------------
# phase 11: serving -- the serving stack above the engine on llama3-8b
# ---------------------------------------------------------------------------

SERVING_KERNELS = ("paged_decode", "paged_past", "chunk_self", "flash_fwd")
SERVING_MAX_SEQ = 2048         # max_seq_len of both replicas' engines
SERVING_CHUNK = 256            # the batchers' prefill_chunk
SERVING_PROMPTS = (300, 1100)  # prompt lengths are drawn from this range
SERVING_NEW = 16               # new tokens of a request that is not held
SERVING_HELD_NEW = 32          # (b)'s and (d)'s held requests: still
                               # decoding when their replica freezes
SERVING_JOIN_S = 300.0         # time limit of every join and wait
SERVING_PAUSE_MB = 512.0       # pause store host budget: (b)'s KV to host


class ServingReplay(FeatureReplay):
    """Phase 11's :class:`Replay`: the first launch of A, B, C and D in the
    replica threads' engine steps (stage ``serving``)."""

    REQUIRED = {(k, "serving") for k in SERVING_KERNELS}


def serving_prompts(V, n: int, seed: int) -> list:
    """``n`` prompts (numpy seed ``seed``) of lengths in SERVING_PROMPTS."""
    rng = np.random.default_rng(seed)
    lo, hi = SERVING_PROMPTS
    return [rng.integers(1, V, int(t)).astype(np.int32)
            for t in rng.integers(lo, hi + 1, n)]


def wait_until(cond, what: str, timeout: float = None) -> None:
    deadline = time.monotonic() + (SERVING_JOIN_S if timeout is None
                                   else timeout)
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"serving: timed out waiting for {what}")


def join_all(threads, what: str) -> None:
    for t in threads:
        t.join(timeout=SERVING_JOIN_S)
    hung = [t.name for t in threads if t.is_alive()]
    if hung:
        raise AssertionError(f"serving: {what}: threads hung {hung}")


def freeze_when_decoding(rep, n: int) -> None:
    """Freeze ``rep``'s worker (its commands still run) right after the
    engine step at which it holds ``n`` requests that all decode, so that
    a part's next move finds them mid-decode whatever the timing."""
    from deepspeed_tpu_torch.serving.request import DECODING

    b = rep.batcher
    step = b.step

    def stepped():
        ran = step()
        live = list(b.manager.active.values())
        if len(live) == n and all(r.state == DECODING for r in live):
            rep.paused = True
            del b.step
        return ran

    b.step = stepped


def hold_decoding(reps, sse, prompts, keys, **kw) -> list:
    """SSE streams ``keys`` (SERVING_HELD_NEW tokens each) started with the
    replicas frozen, one at a time so that the router spreads them evenly;
    then each replica steps until all its requests decode and freezes
    again. Returns the requests each replica holds."""
    for r in reps:
        r.paused = True
    queued = sum(r.stats["queue_depth"] for r in reps)
    for i, (k, p) in enumerate(zip(keys, prompts)):
        sse.start(k, p, max_new_tokens=SERVING_HELD_NEW, **kw)
        wait_until(lambda: sum(r.stats["queue_depth"] for r in reps)
                   == queued + i + 1, f"{k} to be routed")
    for r in reps:
        freeze_when_decoding(r, len(keys) // len(reps))
        r.paused = False
    wait_until(lambda: all(r.paused for r in reps),
               f"{keys} to decode and their replicas to freeze")
    return [r.report()["active_requests"] for r in reps]


def serving_stack(engines, registry, **serving):
    """Two replicas (one batcher each, over ``engines``) behind one router
    and one front-end on 127.0.0.1 (an ephemeral port)."""
    from deepspeed_tpu_torch.config import (FrontendConfig, RouterConfig,
                                            ServingConfig)
    from deepspeed_tpu_torch.serving import (ContinuousBatcher, Replica,
                                             ReplicaRouter, ServingFrontend)

    cfg = ServingConfig(**{"prefill_chunk": SERVING_CHUNK,
                           "default_max_new_tokens": SERVING_NEW,
                           **serving})
    reps = [Replica(f"r{i}", ContinuousBatcher(e, cfg, registry=registry))
            for i, e in enumerate(engines)]
    router = ReplicaRouter(reps, RouterConfig()).start()
    fe = ServingFrontend(router, FrontendConfig(), registry=registry).start()
    return reps, router, fe


def close_stack(tag, engines, reps, router, fe, threads_before,
                shared=None) -> None:
    """Tear a part's stack down and check it left nothing: the socket
    refuses connections, every thread the part started has ended, each
    pool is whole with no live or paused sequence, and the shared
    migration namespace (if any) is empty."""
    import socket
    import threading

    host, port = fe.server.host, fe.server.port
    fe.close()
    router.close()
    for r in reps:
        if r.alive:
            raise AssertionError(f"serving ({tag}): replica {r.name}'s "
                                 f"worker did not join")
    wait_until(lambda: not [t for t in threading.enumerate()
                            if t not in threads_before and t.is_alive()],
               f"({tag}) the part's threads to end", timeout=30.0)
    try:
        socket.create_connection((host, port), timeout=5).close()
        raise AssertionError(f"serving ({tag}): {host}:{port} still "
                             f"accepts connections")
    except OSError:
        pass
    for i, eng in enumerate(engines):
        alloc = eng.state.allocator
        if alloc.free_blocks != alloc.num_blocks or eng.state.sequences \
                or eng._paused:
            raise AssertionError(
                f"serving ({tag}): engine {i} leaked: {alloc.free_blocks} "
                f"of {alloc.num_blocks} blocks free, live "
                f"{sorted(eng.state.sequences)}, paused "
                f"{sorted(eng._paused)}")
        eng.close()          # tier stores: the next part makes its own
    if shared is not None:
        left = [f for _, _, fs in os.walk(shared) for f in fs]
        if left:
            raise AssertionError(f"serving ({tag}): shared namespace "
                                 f"holds {left}")
    log(f"serving ({tag}): torn down; socket closed, threads joined, "
        f"pools whole on both engines")


def tier_client(url, tier=None):
    """A ``GenerateClient`` whose requests carry ``tier`` in their JSON
    body (the protocol's field; the client itself sends none)."""
    from deepspeed_tpu_torch.serving import GenerateClient

    cli = GenerateClient(url, timeout_s=SERVING_JOIN_S)
    if tier is not None:
        post = cli._post
        cli._post = lambda payload, priority: post({**payload, "tier": tier},
                                                   priority)
    return cli


class StreamCollector:
    """SSE streams on client threads; each stream's events land in
    ``events[i]`` as they arrive."""

    def __init__(self, url):
        self.url = url
        self.events = {}
        self.errors = {}
        self.threads = []

    def start(self, i, prompt, tier=None, **kw):
        import threading

        from deepspeed_tpu_torch.serving import FrontendError

        self.events[i] = []

        def run():
            try:
                for ev in tier_client(self.url, tier).stream(
                        [int(t) for t in prompt], **kw):
                    self.events[i].append(ev)
            except FrontendError as e:
                self.errors[i] = e

        t = threading.Thread(target=run, name=f"sse-{i}", daemon=True)
        t.start()
        self.threads.append(t)

    def tokens(self, i) -> list:
        return [e["data"]["token"] for e in self.events[i]
                if e["event"] == "token"]

    def end(self, i) -> dict:
        ends = [e["data"] for e in self.events[i] if e["event"] == "end"]
        if len(ends) != 1:
            raise AssertionError(f"serving: stream {i} has {len(ends)} end "
                                 f"records")
        return ends[0]


def unary_all(url, jobs, results, errors):
    """Unary requests on client threads: ``jobs`` = {key: (prompt, kw)}."""
    import threading

    from deepspeed_tpu_torch.serving import FrontendError

    def run(key, prompt, kw):
        kw = dict(kw)
        try:
            results[key] = tier_client(url, kw.pop("tier", None)).generate(
                [int(t) for t in prompt], **kw)
        except FrontendError as e:
            errors[key] = e

    threads = [threading.Thread(target=run, args=(k, p, kw), daemon=True,
                                name=f"unary-{k}")
               for k, (p, kw) in jobs.items()]
    for t in threads:
        t.start()
    return threads


def teacher_forced_gaps(eng, served) -> dict:
    """For each served (prompt, tokens): how far each token lies below the
    argmax of the teacher-forced logits before it (:func:`sd_gap`), the
    prompts put eight at a time and then their served tokens one step at a
    time. Returns the largest gap per key."""
    keys = list(served)
    worst = {}
    for lo in range(0, len(keys), 8):
        group = keys[lo:lo + 8]
        uids = list(range(700, 700 + len(group)))
        out = eng.put(uids, [served[k][0] for k in group])
        toks = [served[k][1] for k in group]
        gaps = {k: [sd_gap(out[u], t[0])] for k, u, t in zip(group, uids,
                                                             toks)}
        for step in range(1, max(len(t) for t in toks)):
            live = [(k, u, t) for k, u, t in zip(group, uids, toks)
                    if step < len(t)]
            out = eng.put([u for _, u, _ in live],
                          [np.asarray([t[step - 1]], np.int32)
                           for _, _, t in live])
            for k, u, t in live:
                gaps[k].append(sd_gap(out[u], t[step]))
        eng.flush(uids)
        worst.update({k: max(g) for k, g in gaps.items()})
    return worst


def serving(torch, pa, fa, KERNELS, reset_counts, model, tree,
            device="cuda"):
    """Phase 11 on phase 9's model and tree (no new tree, no copy): two
    ``InferenceEngineV2`` replicas (max_seq_len 2048, 8 slots, block 128,
    each batcher's prefill_chunk 256) behind one ``ReplicaRouter`` and one
    ``ServingFrontend``; traffic through ``GenerateClient`` over real
    sockets. (a) tokens over HTTP, (b) SLO preemption, (c) overload, (d) a
    SIGTERM drain whose in-flight requests finish on the draining replica
    and whose queued ones move to the other; after each part, no leaked
    block, thread or socket. Gates: see the module docstring.
    Returns the phase's launches per kernel."""
    import shutil
    import signal
    import tempfile
    import threading

    from deepspeed_tpu_torch import InferenceEngineV2
    from deepspeed_tpu_torch.observability import (MetricsRegistry,
                                                   ServingMetrics)
    from deepspeed_tpu_torch.resilience import (FaultInjector, get_injector,
                                                set_injector)
    from deepspeed_tpu_torch.serving import FrontendError, GenerateClient

    V = model.cfg.vocab_size
    card = card_line() if device == "cuda" else device
    tmp = tempfile.mkdtemp(prefix="dstpu_serving_")
    reg = MetricsRegistry()
    spans = ServingMetrics(reg)  # the batchers' ttft / tpot histograms
    served = {}                  # key -> (prompt, served tokens)

    def engine(tag):
        eng = InferenceEngineV2(model, tree, max_sequences=8,
                                max_seq_len=SERVING_MAX_SEQ, block_size=128,
                                device=device)
        owns_no_copy(tree, eng.params, tag)
        return eng

    def latency_line():
        return "; ".join(
            f"{n}_ms p50 {h.percentile(50):.3f} p90 {h.percentile(90):.3f} "
            f"({h.count} samples)"
            for n, h in (("ttft", spans.ttft_ms), ("tpot", spans.tpot_ms)))

    try:
        free_card(torch, device)
        engines = [engine("r0"), engine("r1")]
        reset_counts()
        replay = ServingReplay(torch, pa, fa)
        with replay:
            replay.stage = "serving"
            # ---- (a) tokens over HTTP: one request alone, then a wave
            before = set(threading.enumerate())
            reps, router, fe = serving_stack(engines, reg)
            prompts = serving_prompts(V, 8, seed=11)
            d0 = KERNELS["flash_fwd"].launches
            cli = GenerateClient(fe.url, timeout_s=SERVING_JOIN_S)
            out = cli.generate([int(t) for t in prompts[0]],
                               max_new_tokens=SERVING_NEW)
            d_alone = KERNELS["flash_fwd"].launches - d0
            if out["state"] != "completed" \
                    or len(out["tokens"]) != SERVING_NEW:
                raise AssertionError(f"serving (a): lone request {out}")
            served["a0"] = (prompts[0], out["tokens"])
            log(f"serving (a): a lone {len(prompts[0])}-token prompt "
                f"served {SERVING_NEW} tokens over HTTP (kernel D launches "
                f"{d_alone}, ttft {out['span']['ttft_ms']} ms)")
            if device == "cuda" and d_alone == 0:
                raise AssertionError("serving (a): the lone request's first "
                                     "chunk did not take kernel D")
            results, errors = {}, {}
            sse = StreamCollector(fe.url)
            threads = unary_all(fe.url, {
                f"a{i}": (prompts[i], dict(max_new_tokens=SERVING_NEW))
                for i in range(1, 6)}, results, errors)
            for i in (6, 7):
                sse.start(f"a{i}", prompts[i], max_new_tokens=SERVING_NEW)
            join_all(threads + sse.threads, "(a)'s clients")
            if errors or sse.errors:
                raise AssertionError(f"serving (a): refused {errors} "
                                     f"{sse.errors}")
            for k, r in results.items():
                if r["state"] != "completed" \
                        or len(r["tokens"]) != SERVING_NEW:
                    raise AssertionError(f"serving (a): {k} {r}")
                served[k] = (prompts[int(k[1:])], r["tokens"])
            for k in ("a6", "a7"):
                end = sse.end(k)
                if end["state"] != "completed" \
                        or end["tokens"] != sse.tokens(k) \
                        or len(end["tokens"]) != SERVING_NEW:
                    raise AssertionError(f"serving (a): stream {k}: tokens "
                                         f"{sse.tokens(k)} end {end}")
                served[k] = (prompts[int(k[1:])], end["tokens"])
            log(f"serving (a): 5 unary requests and 2 SSE streams at once, "
                f"all completed with {SERVING_NEW} tokens; SSE tokens equal "
                f"their end records'; router {router.counters['routed']} "
                f"routed")
            log(f"serving (a) latency [{card}]: {latency_line()}")
            close_stack("a", engines, reps, router, fe, before)

            # ---- (b) SLO preemption: batch-tier work, a latency request
            before = set(threading.enumerate())
            reps, router, fe = serving_stack(
                engines, reg, slo={"enabled": True, "preempt": True,
                                   "pause_host_mb": SERVING_PAUSE_MB})
            prompts = serving_prompts(V, 5, seed=12)
            sse = StreamCollector(fe.url)
            # batch work decoding on both replicas; then, with the workers
            # frozen (commands still run), a latency-tier request and a
            # preempt_storm of one firing per replica, as the reference's
            # slo-storm drill does: admission keeps live blocks under the
            # watermark, so block pressure alone never pauses anyone. A
            # replica's next step pauses a victim (batch before latency),
            # which must resume and complete
            held = hold_decoding(reps, sse, prompts,
                                 [f"b{i}" for i in range(4)], tier="batch")
            if held != [2, 2]:
                raise AssertionError(f"serving (b): batch requests per "
                                     f"replica {held} (want 2 each, "
                                     f"decoding)")
            results, errors = {}, {}
            threads = unary_all(fe.url, {"b4": (prompts[4], dict(
                max_new_tokens=SERVING_NEW, tier="latency"))}, results,
                errors)
            wait_until(lambda: sum(r.stats["queue_depth"] for r in reps)
                       >= 1, "(b)'s latency request to queue")
            set_injector(FaultInjector([{"kind": "preempt_storm",
                                         "times": 2}]))
            for r in reps:
                r.paused = False
            join_all(threads + sse.threads, "(b)'s clients")
            fired = list(get_injector().fired)
            set_injector(None)
            counters = [r.report()["counters"] for r in reps]
            paused = sum(c["paused"] for c in counters)
            resumed = sum(c["resumed"] for c in counters)
            host = sum((e.tier_report() or {}).get("host_demotions", 0)
                       for e in engines)
            if errors or sse.errors or "b4" not in results \
                    or results["b4"]["state"] != "completed":
                raise AssertionError(f"serving (b): latency request "
                                     f"{results} {errors} {sse.errors}")
            victims = []
            for i in range(4):
                end = sse.end(f"b{i}")
                if end["state"] != "completed" \
                        or len(end["tokens"]) != SERVING_HELD_NEW \
                        or end["tokens"] != sse.tokens(f"b{i}"):
                    raise AssertionError(f"serving (b): b{i} {end}")
                if end["span"]["pauses"]:
                    victims.append(f"b{i}")
                served[f"b{i}"] = (prompts[i], end["tokens"])
            served["b4"] = (prompts[4], results["b4"]["tokens"])
            log(f"serving (b): preempt storm fired {fired}; paused "
                f"{paused}, resumed {resumed} (victims {victims}, "
                f"{host} blocks demoted to host); the latency request "
                f"completed with {len(results['b4']['tokens'])} tokens")
            if not (paused >= 1 and resumed == paused and victims
                    and host >= 1):
                raise AssertionError(f"serving (b): no pause -> resume -> "
                                     f"complete ({counters})")
            close_stack("b", engines, reps, router, fe, before)

            # ---- (c) overload: 429 with Retry-After, and 504
            before = set(threading.enumerate())
            reps, router, fe = serving_stack(engines, reg, max_queue_depth=2)
            prompts = serving_prompts(V, 6, seed=13)
            for r in reps:
                r.paused = True
            results, errors = {}, {}
            threads = unary_all(fe.url, {
                f"c{i}": (prompts[i], dict(max_new_tokens=2))
                for i in range(4)}, results, errors)
            wait_until(lambda: sum(r.stats["queue_depth"] for r in reps) >= 4,
                       "(c)'s queues to fill")
            try:
                GenerateClient(fe.url, timeout_s=SERVING_JOIN_S).generate(
                    [int(t) for t in prompts[4]], max_new_tokens=2)
                raise AssertionError("serving (c): a request over the "
                                     "queues' depth was admitted")
            except FrontendError as e:
                over = e
            for r in reps:
                r.paused = False
            join_all(threads, "(c)'s queued clients")
            try:
                GenerateClient(fe.url, timeout_s=SERVING_JOIN_S).generate(
                    [int(t) for t in prompts[5]], max_new_tokens=2,
                    deadline_s=0.001)
                raise AssertionError("serving (c): a past-due request "
                                     "was served")
            except FrontendError as e:
                late = e
            log(f"serving (c): over the queues' depth HTTP {over.status} "
                f"Retry-After {over.retry_after_s} s "
                f"({over.body['error']['reason']}); past-due deadline HTTP "
                f"{late.status}; the {len(results)} queued requests "
                f"completed")
            if over.status != 429 or over.retry_after_s is None \
                    or late.status != 504 or errors \
                    or any(r["state"] != "completed"
                           for r in results.values()):
                raise AssertionError("serving (c): overload mapping")
            close_stack("c", engines, reps, router, fe, before)

            # ---- (d) SIGTERM drain of r0 holding requests mid-decode and
            # queued ones: the in-flight finish on r0, the queued move to
            # r1 (the reference's drain), and with migration on nothing is
            # exported to the shared namespace
            before = set(threading.enumerate())
            shared = os.path.join(tmp, "shared")
            reps, router, fe = serving_stack(
                engines, reg,
                migration={"enabled": True, "shared_nvme_path": shared})
            prompts = serving_prompts(V, 8, seed=14)
            sse = StreamCollector(fe.url)
            held = hold_decoding(reps, sse, prompts[:4],
                                 [f"d{i}" for i in range(4)])
            if held != [2, 2]:
                raise AssertionError(f"serving (d): requests decoding per "
                                     f"replica {held} (want 2 each)")
            for i in range(4, 8):   # queued behind them, two per replica
                sse.start(f"d{i}", prompts[i], max_new_tokens=SERVING_NEW)
                wait_until(lambda: sum(r.stats["queue_depth"] for r in reps)
                           == i - 3, f"(d)'s request d{i} to queue")
            queued_r0 = reps[0].stats["queue_depth"]
            router.install_signal_handlers(drain="r0")
            try:
                os.kill(os.getpid(), signal.SIGTERM)
                wait_until(lambda: router.counters["migrated"]
                           + router.counters["migration_failed"]
                           >= queued_r0, "(d)'s drain to re-home r0's queue")
            finally:
                router.restore_signal_handlers()
            for r in reps:
                r.paused = False
            join_all(sse.threads, "(d)'s streams")
            wait_until(lambda: reps[0].stats["drained"], "r0 to drain")
            inj = get_injector()
            where = {}
            for i in range(8):
                k = f"d{i}"
                end = sse.end(k)
                want = SERVING_HELD_NEW if i < 4 else SERVING_NEW
                if end["state"] != "completed" \
                        or len(end["tokens"]) != want \
                        or end["tokens"] != sse.tokens(k):
                    raise AssertionError(f"serving (d): {k} {end}")
                moves = [(e["data"]["from"], e["data"]["to"])
                         for e in sse.events[k] if e["event"] == "migrated"]
                on = {e["data"]["replica"] for e in sse.events[k]
                      if e["event"] == "token"}
                where[k] = ("".join(sorted(on)), moves)
                served[k] = (prompts[i], end["tokens"])
            inflight_r0 = [f"d{i}" for i in range(4)
                           if where[f"d{i}"] == ("r0", [])]
            moved = [f"d{i}" for i in range(4, 8)
                     if where[f"d{i}"] == ("r1", [("r0", "r1")])]
            rc = dict(router.counters)
            log(f"serving (d): SIGTERM drained r0 holding {inflight_r0} "
                f"mid-decode and {queued_r0} queued; the in-flight "
                f"completed on r0, {moved} moved to r1 and completed; "
                f"router migrated {rc['migrated']}, failed "
                f"{rc['migration_failed']}; injector faults "
                f"{len(inj.faults)}, fired {inj.fired}")
            stayed = [k for k, (on, mv) in where.items()
                      if len(on) == 2 and not mv]
            if len(inflight_r0) != 2 or queued_r0 < 1 \
                    or len(moved) != queued_r0 \
                    or len(stayed) != 8 - queued_r0 \
                    or rc["migrated"] != queued_r0 \
                    or rc["migration_failed"] or inj.faults or inj.fired:
                raise AssertionError(f"serving (d): drain {where} {rc}")
            close_stack("d", engines, reps, router, fe, before, shared)
            replay.stage = None
        counts = {k: v.launches for k, v in KERNELS.items() if v.launches}
        missing = [k for k in SERVING_KERNELS if not counts.get(k)]
        if missing:
            raise AssertionError(f"serving: kernels never launched {missing}"
                                 f" (counts {counts})")
        errs = replay.check()
        log(f"serving: launches {counts}; captured launches replayed vs "
            f"plain, max abs err {errs}")
        log(f"serving latency, all parts [{card}]: {latency_line()}")
        gaps = teacher_forced_gaps(engines[0], served)
        w = max(gaps, key=gaps.get)
        log(f"serving: {sum(len(t) for _, t in served.values())} served "
            f"tokens of {len(served)} requests against teacher-forced "
            f"logits: largest gap below the argmax {gaps[w]:.3e} sd ({w}; "
            f"gate {SPEC_GAP_SD})")
        if gaps[w] > SPEC_GAP_SD:
            raise AssertionError(f"serving: served tokens off the "
                                 f"teacher-forced argmax {gaps}")
        for eng in engines:
            eng.close()
        del engines
    finally:
        set_injector(None)
        shutil.rmtree(tmp, ignore_errors=True)
    free_card(torch, device)
    log(f"serving [{card}]: done")
    return counts


# ---------------------------------------------------------------------------
# phase 12: the elastic fleet (FleetController over a WarmStartCache)
# ---------------------------------------------------------------------------

FLEET_KERNELS = ("qmm", "qmm_stacked", "paged_decode_int8", "paged_past_int8",
                 "chunk_self", "flash_fwd")
FLEET_PRESET = "llama3-8b"
FLEET_PRESET_KW = {"param_dtype": "bfloat16"}
FLEET_WEIGHTS, FLEET_KV = "int4", "int8"     # phase 6's Q1
FLEET_MAX_SEQ = 2048           # max_seq_len of every replica's engine
FLEET_BLOCK = 128
FLEET_CHUNK = 256              # the batchers' prefill_chunk
FLEET_PROMPTS = (300, 1100)    # the storm's prompt lengths (numpy seed 15)
FLEET_STORM = 8
FLEET_NEW = 16
# a worker whose beat is older is recovered as hung: 40 x the slowest step
# phase 11 read (150-250 ms, two busy replicas on one card)
FLEET_HEARTBEAT_S = 10.0
FLEET_BURST = 48               # the reference drill's burst: 3-token
FLEET_BURST_NEW = 16           # prompts, 16 new tokens each
FLEET_TRICKLE_S = 0.25         # gap between (d)'s trickled requests
FLEET_JOIN_S = 600.0


class FleetReplay(Replay):
    """Phase 12's :class:`Replay`: the first launch of G, H, A and B over
    the int8 pool, C and D in the replicas' engine steps (stage
    ``fleet``)."""

    REQUIRED = {(k, "fleet") for k in FLEET_KERNELS}

    def __init__(self, torch, pa, qm, fa):
        self.qm = qm
        super().__init__(torch, pa, (qm, fa))

    @staticmethod
    def make_targets(pa, mods):
        qm, fa = mods
        return {**Replay.make_targets(pa, fa),
                **QuantReplay.make_targets(pa, qm)}

    def kernel_of(self, target, x):
        if target == "qmm":
            return QuantReplay.kernel_of(self, target, x)
        return super().kernel_of(target, x)

    def _wanted(self, target, name, x) -> bool:
        return self.stage is not None and super()._wanted(target, name, x)


def fs_type(path: str) -> str:
    """The filesystem type and mount point holding ``path`` (from
    ``/proc/mounts``; ``unknown`` where it cannot be read)."""
    path = os.path.realpath(path)
    best = ("unknown", "")
    try:
        with open("/proc/mounts") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 3 and (path == parts[1] or path.startswith(
                        parts[1].rstrip("/") + "/")) \
                        and len(parts[1]) >= len(best[1]):
                    best = (parts[2], parts[1])
    except OSError:
        pass
    return f"{best[0]} at {best[1] or '?'}"


class BeatWatch:
    """A sampler thread over a router's pool: the largest gap between a
    live replica's heartbeats (``stats["beat"]``) and the fewest READY,
    routable replicas, every 20 ms while running."""

    def __init__(self, router):
        import threading

        self.router = router
        self.max_gap = 0.0
        self.min_ready = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fleet-beat-watch")
        self._thread.start()

    def _run(self):
        from deepspeed_tpu_torch.serving import READY

        while not self._stop.wait(0.02):
            now = time.monotonic()
            reps = self.router._snapshot()
            for r in reps:
                if r.alive:
                    self.max_gap = max(self.max_gap, now - r.stats["beat"])
            ready = sum(1 for r in reps
                        if r.routable and r.stats["health"] == READY)
            self.min_ready = (ready if self.min_ready is None
                              else min(self.min_ready, ready))

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)
        self.router = None
        return self


def held_engines(engines, router) -> list:
    """Engines of ``engines`` (weak references) that are still alive but
    serve no replica of ``router``'s pool: a dead or swapped-out replica's
    weights and KV pool must go with it."""
    gc.collect()
    live = {id(r.batcher.engine) for r in router._snapshot()}
    return [i for i, ref in enumerate(engines)
            if ref() is not None and id(ref()) not in live]


def greedy_tokens(eng, prompts, steps: int) -> dict:
    """Greedy tokens of ``prompts`` on ``eng``: one ``put``, then
    ``decode_batch``; the uids are flushed after."""
    uids = list(range(len(prompts)))
    out = eng.put(uids, prompts)
    nxt = [int(np.argmax(out[u])) for u in uids]
    toks = eng.decode_batch(uids, nxt, steps=steps)
    eng.flush(uids)
    return {u: [nxt[u]] + [int(t) for t in toks[u]] for u in uids}


def fleet(torch, pa, qm, fa, KERNELS, reset_counts, device="cuda"):
    """Phase 12: the elastic fleet at ``llama3-8b`` full width and depth,
    int4 weights and an int8 pool (phase 6's Q1), every replica (max_seq_len
    2048, 8 slots, block 128, prefill_chunk 256) built through one
    ``WarmStartCache`` in a temporary directory, the replicas sharing one
    migration namespace there. (a) cold start, publish, warm start; (b) a
    replica crash mid-storm, respawned warm; (c) burst autoscale; (d) a
    rolling swap under a trickle; (e) nothing leaked, the card's memory
    back. Gates: see the module docstring. Returns the phase's launches
    per kernel."""
    import glob
    import shutil
    import tempfile
    import threading
    import weakref

    from deepspeed_tpu_torch import TransformerLM
    from deepspeed_tpu_torch.config import FleetConfig
    from deepspeed_tpu_torch.observability import configure_tracing, get_bus
    from deepspeed_tpu_torch.resilience import (FaultInjector, FaultSpec,
                                                set_injector)
    from deepspeed_tpu_torch.serving import (READY, FleetController,
                                             ReplicaRouter, ShedError,
                                             WarmStartCache)
    from deepspeed_tpu_torch.serving.coldstart import evict_module
    from deepspeed_tpu_torch.tools.elastic_drill import (
        Setup, await_terminal, pool_invariants, replica_factory,
        shared_tier_leftovers, storm, trees_equal)

    cuda = torch.device(device).type == "cuda"
    card = card_line() if cuda else device
    tmp = tempfile.mkdtemp(prefix="dstpu_fleet_")
    setup = Setup(device=device, preset=FLEET_PRESET,
                  preset_kw=dict(FLEET_PRESET_KW),
                  weight_dtype=FLEET_WEIGHTS, kv_dtype=FLEET_KV,
                  max_sequences=8, max_seq_len=FLEET_MAX_SEQ,
                  block_size=FLEET_BLOCK, prefill_chunk=FLEET_CHUNK)
    V = setup.model_config().vocab_size
    rng = np.random.default_rng(15)
    lo, hi = FLEET_PROMPTS
    prompts = [rng.integers(1, V, int(t)).astype(np.int32)
               for t in rng.integers(lo, hi + 1, FLEET_STORM)]
    fleet_cfg = dict(respawn_backoff_s=0.0,
                     heartbeat_timeout_s=FLEET_HEARTBEAT_S,
                     probe_timeout_s=FLEET_JOIN_S)
    gaps = []
    cache = WarmStartCache(os.path.join(tmp, "warm"))
    build, key = replica_factory(tmp, setup, cache)
    engines = []               # a weak reference to every replica's engine
    loads = []                 # every warm build's stream: (GB, read, all)

    def factory(name):
        rep = build(name)
        engines.append(weakref.ref(rep.batcher.engine))
        if rep.start_info["source"] == "warm":
            ld = cache.last_load
            loads.append((ld["bytes"] / 1e9, ld["read_ms"], ld["ms"]))
        return rep

    free_card(torch, device)
    base = torch.cuda.memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    reps = []
    try:
        evict_module(key)
        reset_counts()
        replay = FleetReplay(torch, pa, qm, fa)
        with replay:
            replay.stage = "fleet"
            # ---- (a) cold start, publish, warm start
            t0 = time.perf_counter()
            r0 = factory("r0")
            publish_ms = (time.perf_counter() - t0) * 1e3 \
                - r0.start_info["ms"]
            w = factory("w0")
            cold_ms, warm_ms = r0.start_info["ms"], w.start_info["ms"]
            load = dict(cache.last_load)
            gbps = load["bytes"] / (load["ms"] * 1e6)
            if (r0.start_info["source"], w.start_info["source"]) \
                    != ("cold", "warm") or cache.counters["publishes"] != 1:
                raise AssertionError(f"fleet (a): sources "
                                     f"{r0.start_info} {w.start_info}, "
                                     f"cache {cache.report()}")
            if not trees_equal(w.batcher.engine.params,
                               r0.batcher.engine.params):
                raise AssertionError("fleet (a): the warm tree differs from "
                                     "the published cold tree")
            toks = [greedy_tokens(r.batcher.engine, prompts[:2], FLEET_NEW)
                    for r in (r0, w)]
            if toks[0] != toks[1]:
                raise AssertionError(f"fleet (a): warm greedy tokens "
                                     f"{toks[1]} vs cold {toks[0]}")
            w.close()
            del w
            free_card(torch, device)
            fallbacks = []
            set_injector(FaultInjector([FaultSpec(
                kind="weight_load_io_error", site="warm")]))
            try:
                eng, info = cache.build_engine(
                    key, lambda: TransformerLM(setup.model_config()),
                    engine_kw=setup.engine_kw(), publish=False)
            finally:
                set_injector(None)
            fallbacks.append(info)
            del eng
            free_card(torch, device)
            mp = cache.manifest_path(key)
            shutil.copy(mp, mp + ".good")
            with open(mp, "w") as f:
                f.write('{"schema": 1, "leaves": [')
            eng, info = cache.build_engine(
                key, lambda: TransformerLM(setup.model_config()),
                engine_kw=setup.engine_kw(), publish=False)
            os.replace(mp + ".good", mp)
            fallbacks.append(info)
            del eng
            free_card(torch, device)
            if [f["source"] for f in fallbacks] != ["cold", "cold"] \
                    or cache.counters["warm_load_failures"] != 2:
                raise AssertionError(f"fleet (a): fallbacks {fallbacks}, "
                                     f"cache {cache.report()}")
            log(f"fleet (a) [{card}]: cold build {cold_ms} ms, publish "
                f"{publish_ms:.1f} ms, warm build {warm_ms} ms (cold / warm "
                f"{cold_ms / warm_ms:.2f}); warm stream "
                f"{load['bytes'] / 1e9:.3f} GB in {load['ms']:.1f} ms "
                f"({gbps:.2f} GB/s, read + upload) from {fs_type(tmp)}")
            log(f"fleet (a): warm tree equal to the published cold tree, "
                f"greedy tokens of 2 prompts equal; injected "
                f"weight_load_io_error -> {fallbacks[0]}, corrupt manifest "
                f"-> {fallbacks[1]}")

            # ---- (b) a replica crash mid-storm, respawned warm
            dump_dir = os.path.join(tmp, "flight")
            configure_tracing(enabled=True, ring_size=4096, sample=1,
                              dump_dir=dump_dir)
            router = ReplicaRouter([r0, factory("r1")]).start()
            reps = [router]
            fc = FleetController(router, factory, FleetConfig(**fleet_cfg))
            watch = BeatWatch(router)
            inc0 = r0.incarnation
            uids, rejected = storm(router, FLEET_STORM, FLEET_NEW,
                                   prompts=prompts)
            wait_until(lambda: r0.stats["active"] > 0,
                       "(b)'s storm to reach r0", FLEET_JOIN_S)
            set_injector(FaultInjector([FaultSpec(kind="replica_crash",
                                                  site="r0")]))
            wait_until(lambda: not r0.alive, "r0 to crash", FLEET_JOIN_S)
            set_injector(None)
            actions = fc.poll()
            del r0                   # the dead incarnation
            inv = pool_invariants(router, uids, FLEET_JOIN_S)
            new_r0 = router.replicas["r0"]
            # the sampler's last snapshot of the pool may still hold the
            # dead incarnation: stop it before looking for held engines,
            # as (c) and (d) do
            gaps.append(watch.stop().max_gap)
            held = held_engines(engines, router)
            post = router.submit([int(t) for t in prompts[2]],
                                 max_new_tokens=FLEET_NEW)
            post_left = await_terminal(router, [post], FLEET_JOIN_S)
            dumps = glob.glob(os.path.join(dump_dir,
                                           "flight_replica_crash_*"))
            log(f"fleet (b): storm of {len(uids)} ({rejected} rejected), "
                f"r0 crashed with {inv['terminal_counts']}; recovered "
                f"{actions['recovered']}; r0 incarnation {inc0} -> "
                f"{new_r0.incarnation} ({new_r0.start_info}); router "
                f"crash_failovers {router.counters['crash_failovers']}, "
                f"readmits {router.counters['readmits']}; flight dumps "
                f"{[os.path.basename(d) for d in dumps]}")
            if not (actions["recovered"]
                    and actions["recovered"][0]["respawned"] and inv["ok"]
                    and new_r0.alive and new_r0.incarnation > inc0
                    and new_r0.start_info["source"] == "warm"
                    and router.counters["readmits"] == 1
                    and not post_left and len(dumps) == 1 and not held):
                raise AssertionError(f"fleet (b): {actions} {inv} "
                                     f"post {post_left} dumps {dumps}, "
                                     f"engines held {held}")
            router.close()
            fc.close()
            reps = []
            del new_r0, router, fc, watch
            configure_tracing(enabled=False)
            get_bus().clear()
            left = shared_tier_leftovers(tmp)
            if left:
                raise AssertionError(f"fleet (b): shared tier holds {left}")
            free_card(torch, device)

            # ---- (c) burst autoscale (the reference drill's settings)
            router = ReplicaRouter([factory("r0")]).start()
            reps = [router]
            fc = FleetController(router, factory, FleetConfig(**{
                **fleet_cfg, "min_replicas": 1, "max_replicas": 3,
                "scale_up_queue_per_replica": 2.0, "scale_up_polls": 2,
                "scale_down_idle_polls": 3}))
            watch = BeatWatch(router)
            uids, rejected = storm(router, FLEET_BURST, FLEET_BURST_NEW)
            polls = 0
            while fc.counters["scale_ups"] == 0 and polls < 20:
                fc.poll()
                polls += 1
                time.sleep(0.02)
            grew_to = len(router.replicas)
            inv = pool_invariants(router, uids, FLEET_JOIN_S)
            polls = 0
            while len(router.replicas) > 1 and polls < 60:
                fc.poll()
                polls += 1
                time.sleep(0.02)
            gaps.append(watch.stop().max_gap)
            held = held_engines(engines, router)
            log(f"fleet (c): burst of {len(uids)} ({rejected} rejected): "
                f"pool 1 -> {grew_to} -> "
                f"{len(router.replicas)}; scale_ups "
                f"{fc.counters['scale_ups']}, scale_downs "
                f"{fc.counters['scale_downs']}; {inv['terminal_counts']}")
            if not (grew_to >= 2 and len(router.replicas) == 1
                    and fc.counters["scale_downs"] >= 1 and inv["ok"]
                    and not held):
                raise AssertionError(f"fleet (c): {fc.report()} {inv}, "
                                     f"engines held {held}")
            router.close()
            fc.close()
            reps = []
            del router, fc, watch
            free_card(torch, device)

            # ---- (d) a rolling swap of two replicas under a trickle
            router = ReplicaRouter([factory("r0"), factory("r1")]).start()
            reps = [router]
            fc = FleetController(router, factory, FleetConfig(**{
                **fleet_cfg, "min_ready_floor": 1}))
            before = {r.name: r.incarnation for r in router._snapshot()}
            live, stop, shed = [], threading.Event(), []

            def trickle():
                i = 0
                while not stop.is_set():
                    try:
                        live.append(router.submit(
                            [int(t) for t in prompts[i % len(prompts)]],
                            max_new_tokens=4))
                    except ShedError as e:
                        shed.append(repr(e))
                    i += 1
                    time.sleep(FLEET_TRICKLE_S)

            t = threading.Thread(target=trickle, daemon=True,
                                 name="fleet-trickle")
            t.start()
            try:
                # the swap starts once both replicas have stepped (READY)
                wait_until(lambda: all(r.stats["health"] == READY
                                       for r in router._snapshot()),
                           "(d)'s replicas to be READY", FLEET_JOIN_S)
                watch = BeatWatch(router)
                res = fc.rolling_swap(drain_timeout_s=FLEET_JOIN_S)
            finally:
                stop.set()
                t.join(timeout=30)
            del t, trickle
            inv = pool_invariants(router, live, FLEET_JOIN_S)
            gaps.append(watch.stop().max_gap)
            held = held_engines(engines, router)
            after = {r.name: r.incarnation for r in router._snapshot()}
            states = {u: router.resolve(u) for u in live}
            log(f"fleet (d): rolling swap {res}; incarnations {before} -> "
                f"{after}; {len(live)} trickled ({len(shed)} refused), "
                f"{inv['terminal_counts']}; fewest READY replicas "
                f"{watch.min_ready} (floor 1); {len(engines)} engines "
                f"built in the phase, {len(held)} held past their replica")
            if not (res["ok"] and inv["ok"] and live
                    and all(after[n] > before[n] for n in before)
                    and watch.min_ready >= 1 and not held
                    and set(states.values()) == {"completed"}):
                raise AssertionError(f"fleet (d): {res} {inv} {states}, "
                                     f"engines held {held}")
            # ---- (e) nothing leaked
            left = shared_tier_leftovers(tmp)
            if left:
                raise AssertionError(f"fleet (e): shared tier holds {left}")
            pool_bytes = sum(
                t.numel() * t.element_size()
                for t in router.replicas["r0"].batcher.engine.cache.values()
                if isinstance(t, torch.Tensor))
            router.close()
            fc.close()
            reps = []
            del router, fc, watch
            replay.stage = None
        counts = {k: v.launches for k, v in KERNELS.items() if v.launches}
        missing = [k for k in FLEET_KERNELS if not counts.get(k)]
        if missing:
            raise AssertionError(f"fleet: kernels never launched {missing} "
                                 f"(counts {counts})")
        errs = replay.check()
        del replay
        log(f"fleet: launches {counts}; captured launches replayed vs "
            f"plain, max abs err {errs}")
        cache.close()
        evict_module(key)
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
        gc.collect()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            now = torch.cuda.memory_allocated()
            log(f"fleet (e) [{card}]: card memory {base / 1e9:.3f} GB "
                f"before the phase, {now / 1e9:.3f} GB after every replica "
                f"closed (one replica's KV pool {pool_bytes / 1e9:.3f} GB); "
                f"peak {peak:.2f} GB")
            if now - base > pool_bytes:
                raise AssertionError(f"fleet (e): {(now - base) / 1e9:.3f} "
                                     f"GB of the card still held")
        streams = [(round(g, 3), round(r, 1), round(a, 1),
                    round(g / a * 1e3, 2)) for g, r, a in loads]
        log(f"fleet (e) [{card}]: every warm build's stream (GB, read ms, "
            f"read + upload ms, GB/s): {streams}")
        log(f"fleet (e) [{card}]: largest gap between a live replica's "
            f"beats {max(gaps) * 1e3:.1f} ms ((b), (c), (d): "
            f"{[round(g * 1e3, 1) for g in gaps]}) against "
            f"heartbeat_timeout_s {FLEET_HEARTBEAT_S}; phase "
            f"{time.perf_counter() - t_phase:.1f} s")
    finally:
        for router in reps:
            router.close()
        set_injector(None)
        configure_tracing(enabled=False)
        cache.close()
        evict_module(key)
        shutil.rmtree(tmp, ignore_errors=True)
    free_card(torch, device)
    log(f"fleet [{card}]: done")
    return counts


# ---------------------------------------------------------------------------
# phase 13: engine checkpoints and the resilience layer
# ---------------------------------------------------------------------------

CKPT_KERNELS = TRAIN_KERNELS   # D, E, F while training (v1 serving: counted)
# overrides of phase 5's model: 4 of its 16 layers (a depth cut that keeps
# the whole script inside its time limit; every gate is depth-free)
CKPT_MODEL_KW: dict = {"num_layers": 4}
CKPT_SEQ = None                # tokens a row (None: phase 5's TRAIN_SEQ)
CKPT_STEPS = 2                 # train_batch steps before the save, and after
CKPT_SCHEDULE = {"type": "WarmupLR", "params": {
    "warmup_min_lr": 0.0, "warmup_max_lr": 1e-4, "warmup_num_steps": 10,
    "warmup_type": "linear"}}
CKPT_PROMPTS = (37, 128)       # (e): two prompts, greedy
CKPT_NEW = 16
CKPT_MEM_SLACK = 16 << 20      # card bytes the phase may leave allocated
CKPT_HB_DEADLINE_S = 5.0       # (c)'s heartbeat step deadline


class CheckpointReplay(TrainReplay):
    """Phase 13's :class:`Replay`: the first launch of each of
    ``CKPT_KERNELS`` (stage ``checkpoint``)."""

    def __init__(self, torch, fa):
        super().__init__(torch, fa)
        self.REQUIRED = {(k, "checkpoint") for k in CKPT_KERNELS}

    def _wanted(self, target, name, x) -> bool:
        return self.stage is not None and super()._wanted(target, name, x)


def ckpt_model():
    """Phase 5's model (``CKPT_MODEL_KW`` applied)."""
    import dataclasses

    from deepspeed_tpu_torch import TransformerLM
    from deepspeed_tpu_torch.tools.train_profile import train_model_config

    return TransformerLM(dataclasses.replace(train_model_config(),
                                             **CKPT_MODEL_KW))


def ckpt_config(seed: int, **extra) -> dict:
    """Phase 5's ``TRAIN_CONFIG`` with a warm-up schedule (so the
    scheduler's state rides the checkpoint) and ``seed``."""
    from deepspeed_tpu_torch.tools.train_profile import TRAIN_CONFIG

    return {**TRAIN_CONFIG, "scheduler": CKPT_SCHEDULE, "seed": seed,
            **extra}


def ckpt_batch(vocab: int) -> dict:
    from deepspeed_tpu_torch.tools.train_profile import (TRAIN_CONFIG,
                                                         TRAIN_SEQ)

    rng = np.random.default_rng(0)
    micro = TRAIN_CONFIG["train_micro_batch_size_per_gpu"]
    return {"input_ids": rng.integers(
        0, vocab, (micro, CKPT_SEQ or TRAIN_SEQ)).astype(np.int32)}


def state_snapshot(eng) -> dict:
    """Host copies of an engine's whole training state: every param leaf,
    every optimizer leaf (by its param's name), the update count, the scaler, the
    schedule's state and the step counters."""
    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, f"{prefix}{k}/")
        else:
            yield prefix[:-1], tree

    names = [n for n, _ in walk(eng.params, "")]
    snap = {f"params/{n}": t.detach().to("cpu", copy=True)
            for n, t in walk(eng.params, "")}
    for key, val in eng.opt_state.items():
        if isinstance(val, list):     # per leaf, in the engine's leaf order
            for n, t in zip(names, val):
                snap[f"opt/{key}/{n}"] = t.detach().to("cpu", copy=True)
        else:
            snap[f"opt/{key}"] = val
    snap["scaler"] = dict(eng.scaler_state)
    snap["lr_scheduler"] = (None if eng.lr_scheduler is None
                            else eng.lr_scheduler.state_dict())
    snap["counters"] = (eng.global_steps, eng.global_samples,
                        eng.micro_steps, eng.skipped_steps)
    return snap


def snapshots_equal(torch, got: dict, want: dict) -> list:
    """Keys of two snapshots that differ (tensors by ``torch.equal``)."""
    bad = sorted(set(got) ^ set(want))
    for k in set(got) & set(want):
        a, b = got[k], want[k]
        same = (torch.equal(a, b) and a.dtype == b.dtype
                if isinstance(a, torch.Tensor) else a == b)
        if not same:
            bad.append(k)
    return sorted(bad)


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)


def tag_dirs(root: str) -> list:
    """Every checkpoint tag directory under ``root`` (its checkpoint
    directories one level down)."""
    out = []
    for d, dirs, files in os.walk(root):
        if "meta.json" in files:
            out.append(os.path.relpath(d, root))
    return sorted(out)


def ckpt_train(eng, batch, steps: int, sync) -> tuple:
    """``steps`` train_batch steps: (losses, wall ms of each)."""
    losses, ms = [], []
    for _ in range(steps):
        t = time.perf_counter()
        losses.append(eng.train_batch(itertools.repeat(batch)))
        sync()
        ms.append((time.perf_counter() - t) * 1e3)
    return losses, ms


class LatestWatch:
    """Polls a checkpoint directory every 20 ms while an async commit runs:
    whenever ``latest`` names ``tag``, the tag's manifest must already be
    there and its ``.staging`` sentinel gone. (The manifest's sha256 pass
    alone takes seconds at full size, so 20 ms sees a wrong order.)"""

    def __init__(self, ckpt_dir: str, tag: str):
        import threading

        from deepspeed_tpu_torch.resilience.manager import (MANIFEST_FILE,
                                                            STAGING_FILE)

        self.latest = os.path.join(ckpt_dir, "latest")
        self.manifest = os.path.join(ckpt_dir, tag, MANIFEST_FILE)
        self.staging = os.path.join(ckpt_dir, tag, STAGING_FILE)
        self.tag = tag
        self.polls = self.seen_staged = 0
        self.violations = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="latest-watch")
        self._thread.start()

    def _run(self):
        while not self._stop.wait(0.02):
            self.polls += 1
            try:
                with open(self.latest) as f:
                    named = f.read().strip()
            except OSError:
                named = None
            if named != self.tag:
                self.seen_staged += os.path.exists(self.staging)
                continue
            if not os.path.exists(self.manifest) \
                    or os.path.exists(self.staging):
                self.violations.append(self.polls)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)
        return self


def ckpt_roundtrip(torch, tmp, device, sync, card):
    """(a): engine A trains, saves synchronously, trains on; engine B (seed
    1) loads the tag, equals A's state at the save and repeats A's steps.
    Returns A's state at the save and the numbers."""
    import shutil

    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.runtime.checkpoint import save_16bit_model

    model = ckpt_model()
    V = model.cfg.vocab_size
    batch = ckpt_batch(V)
    ckpt = os.path.join(tmp, "a")
    eng, *_ = initialize(model, ckpt_config(0), device=device)
    losses_a, _ = ckpt_train(eng, batch, CKPT_STEPS, sync)
    saved = state_snapshot(eng)
    t = time.perf_counter()
    eng.save_checkpoint(ckpt)
    sync()
    save_ms = (time.perf_counter() - t) * 1e3
    nbytes = dir_bytes(ckpt)
    after_a, _ = ckpt_train(eng, batch, CKPT_STEPS, sync)
    final_a = {k: v for k, v in state_snapshot(eng).items()
               if k.startswith("params/")}
    del eng
    free_card(torch, device)
    # the gate's premise: A's steps are deterministic on this device (a
    # second run of them, no save between, gives the same bits)
    eng, *_ = initialize(model, ckpt_config(0), device=device)
    again, _ = ckpt_train(eng, batch, 2 * CKPT_STEPS, sync)
    bad = snapshots_equal(torch, {k: v for k, v in state_snapshot(
        eng).items() if k.startswith("params/")}, final_a)
    del eng
    free_card(torch, device)
    if again != losses_a + after_a or bad:
        raise AssertionError(f"checkpoint (a): A's steps are not "
                             f"deterministic: losses {again} vs "
                             f"{losses_a + after_a}, leaves {bad[:8]}")

    eng, *_ = initialize(model, ckpt_config(1), device=device)
    fresh = state_snapshot(eng)
    if not [k for k in saved if k.startswith("params/")
            and not torch.equal(fresh[k], saved[k])]:
        raise AssertionError("checkpoint (a): engine B starts from A's "
                             "weights")
    t = time.perf_counter()
    path, client = eng.load_checkpoint(ckpt)
    sync()
    load_ms = (time.perf_counter() - t) * 1e3
    bad = snapshots_equal(torch, state_snapshot(eng), saved)
    if bad:
        raise AssertionError(f"checkpoint (a): loaded state differs from "
                             f"the saved state at {bad[:8]}")
    out16 = save_16bit_model(eng, tmp, "model_fp16.npz")
    after_b, _ = ckpt_train(eng, batch, CKPT_STEPS, sync)
    final_b = {k: v for k, v in state_snapshot(eng).items()
               if k.startswith("params/")}
    del eng
    free_card(torch, device)
    if after_b != after_a:
        raise AssertionError(f"checkpoint (a): resumed losses {after_b} != "
                             f"A's {after_a}")
    bad = snapshots_equal(torch, final_b, final_a)
    if bad:
        raise AssertionError(f"checkpoint (a): resumed leaves differ from "
                             f"A's at {bad[:8]}")
    free = shutil.disk_usage(tmp)
    log(f"checkpoint (a) [{card}]: {ckpt_model().cfg.num_layers} layers, "
        f"losses {losses_a} then {after_a} (A) / {after_b} (B resumed, "
        f"equal bit for bit, every leaf torch.equal; a second run of A's "
        f"{2 * CKPT_STEPS} steps equal too); loaded state equals "
        f"the saved state bit for bit ({len(saved)} entries); save "
        f"{save_ms:.1f} ms, load {load_ms:.1f} ms, {nbytes} bytes, save "
        f"{nbytes / save_ms / 1e6:.3f} GB/s, load "
        f"{nbytes / load_ms / 1e6:.3f} GB/s; {tmp}: {fs_type(tmp)}, "
        f"disk_usage total {free.total}, used {free.used}, free "
        f"{free.free}")
    return {"saved": saved, "ckpt": ckpt, "bytes": nbytes, "fp16": out16,
            "save_ms": save_ms, "load_ms": load_ms, "V": V,
            "model": model}


def ckpt_async(torch, tmp, device, sync, card, tag_bytes: int):
    """(b): an async save under ``resilience.enabled`` with both
    ``checkpoint.async_save`` flags, at (a)'s depth; the next step runs
    while the commit thread writes. The watch on ``latest`` starts after
    that step, so its polls are not in the step's time."""
    import shutil
    import threading

    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.resilience.manager import (STAGING_FILE,
                                                        verify_tag_dir)
    from deepspeed_tpu_torch.runtime.checkpoint import read_latest_tag

    free = shutil.disk_usage(tmp).free
    if free < tag_bytes:
        raise AssertionError(f"checkpoint (b): {tmp} has {free} bytes free, "
                             f"less than a second {tag_bytes}-byte tag")
    model = ckpt_model()
    batch = ckpt_batch(model.cfg.vocab_size)
    ckpt = os.path.join(tmp, "b")
    eng, *_ = initialize(model, ckpt_config(0, checkpoint={
        "async_save": True}, resilience={"enabled": True, "checkpoint": {
            "async_save": True, "keep_last_k": 2}}), device=device)
    before = {t.ident for t in threading.enumerate()}
    _, step_ms = ckpt_train(eng, batch, 2, sync)
    tag = f"global_step{eng.global_steps}"
    t = time.perf_counter()
    eng.save_checkpoint(ckpt)
    stage_ms = (time.perf_counter() - t) * 1e3
    commit = [t for t in threading.enumerate()
              if t.ident not in before and t.name.startswith("ckpt")]
    mgr = eng._primary_mgr
    _, overlap_ms = ckpt_train(eng, batch, 1, sync)
    running = [t.name for t in commit if t.is_alive()]
    watch = LatestWatch(ckpt, tag)
    eng.shutdown()
    watch.stop()
    alive = [t.name for t in commit if t.is_alive()]
    # the manager times its save from before the stage to ``latest``
    save_ms = mgr.async_stats["last_latency_s"] * 1e3
    commit_ms = save_ms - stage_ms
    mgr_commits = mgr.async_stats["commits"]
    ok, why = verify_tag_dir(os.path.join(ckpt, tag))
    tags = tag_dirs(tmp)
    del eng, mgr
    free_card(torch, device)
    problems = []
    if not ok:
        problems.append(f"tag does not verify: {why}")
    if read_latest_tag(ckpt) != tag:
        problems.append(f"latest names {read_latest_tag(ckpt)}")
    if os.path.exists(os.path.join(ckpt, tag, STAGING_FILE)):
        problems.append("the .staging sentinel is left")
    if watch.violations:
        problems.append(f"latest named the tag before its manifest "
                        f"({len(watch.violations)} polls)")
    if alive or mgr_commits != 1:
        problems.append(f"commits {mgr_commits}, commit threads alive "
                        f"after shutdown {alive}")
    if len(tags) > 2:
        problems.append(f"{len(tags)} tags on disk: {tags}")
    if problems:
        raise AssertionError(f"checkpoint (b): {problems}")
    log(f"checkpoint (b) [{card}]: {model.cfg.num_layers} layers (free "
        f"bytes {free} for a {tag_bytes}-byte tag); stage (device -> host "
        f"copy) {stage_ms:.1f} ms, commit (end of stage -> latest: writes, "
        f"manifest sha256, latest) {commit_ms:.1f} ms, save start -> latest "
        f"{save_ms:.1f} ms, "
        f"the step during the commit {overlap_ms[0]:.1f} ms (commit threads "
        f"still running at its end: {running}) beside {step_ms[-1]:.1f} ms "
        f"before the save and phase 5's "
        f"{PHASE_NOTES.get('train_step_ms', 'not run')} ms; latest moved "
        f"after the manifest ({watch.polls} polls, staged seen "
        f"{watch.seen_staged}); tag verifies; tags on disk {tags}")
    return {"stage_ms": stage_ms, "commit_ms": commit_ms,
            "overlap_ms": overlap_ms[0]}


def ckpt_tiny_engine(device, **resilience):
    """(c)'s engine: the tiny preset (widened on the card to a head dim the
    kernels take), resilience on."""
    import torch

    from deepspeed_tpu_torch import TransformerLM, get_preset, initialize
    from deepspeed_tpu_torch.tools.crash_resume import _CARD_TINY

    kw = dict(_CARD_TINY) if torch.device(device).type == "cuda" else {}
    res = {"enabled": True, **resilience}
    eng, *_ = initialize(TransformerLM(get_preset("tiny", **kw)), {
        "train_micro_batch_size_per_gpu": 2,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
        "steps_per_print": 100, "resilience": res}, device=device)
    return eng


def tiny_steps(eng, n: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        loss = eng.forward({"input_ids": rng.integers(0, 256, (2, 32))})
        eng.backward(loss)
        eng.step()
        out.append(float(loss.detach()))
    return out


def ckpt_drill(torch, tmp, device, card):
    """(c): the reference's resilience outcomes on tiny engines."""
    import signal

    from deepspeed_tpu_torch.resilience import (set_injector,
                                                tear_checkpoint_dir)
    from deepspeed_tpu_torch.resilience.manager import verify_tag_dir
    from deepspeed_tpu_torch.runtime.checkpoint import read_latest_tag

    out = {}
    prev_term = signal.getsignal(signal.SIGTERM)
    try:
        # torn newest tag -> the load falls back to the previous verified one
        d = os.path.join(tmp, "torn")
        eng = ckpt_tiny_engine(device)
        tiny_steps(eng, 2)
        eng.save_checkpoint(d)
        tiny_steps(eng, 1)
        eng.save_checkpoint(d)
        eng.shutdown()
        tear_checkpoint_dir(os.path.join(d, "global_step3"), mode="truncate")
        eng = ckpt_tiny_engine(device)
        path, _ = eng.load_checkpoint(d)
        rep = eng.resilience_report()["checkpoint"]
        eng.shutdown()
        if not (path.endswith("global_step2") and eng.global_steps == 2
                and rep["verify_failures"] >= 1
                and rep["load_fallbacks"] == 1
                and read_latest_tag(d) == "global_step2"):
            raise AssertionError(f"checkpoint (c) torn: {path} {rep}")
        out["torn"] = {k: rep[k] for k in ("verify_failures",
                                           "load_fallbacks")}
        # keep-last-K
        d = os.path.join(tmp, "gc")
        eng = ckpt_tiny_engine(device, checkpoint={"keep_last_k": 2})
        for _ in range(4):
            tiny_steps(eng, 1)
            eng.save_checkpoint(d)
        tags = sorted(t for t in os.listdir(d)
                      if os.path.isdir(os.path.join(d, t)))
        gc_removed = eng.resilience_report()["checkpoint"]["gc_removed"]
        eng.shutdown()
        if tags != ["global_step3", "global_step4"] or gc_removed != 2 or \
                not all(verify_tag_dir(os.path.join(d, t))[0] for t in tags):
            raise AssertionError(f"checkpoint (c) keep-last-K: {tags} "
                                 f"gc_removed {gc_removed}")
        out["gc"] = tags
        # an injected IO error is retried and the save lands
        d = os.path.join(tmp, "io")
        eng = ckpt_tiny_engine(device, retry={"max_attempts": 3,
                                              "base_delay_s": 0.001},
                               faults=[{"kind": "io_error", "times": 2}])
        tiny_steps(eng, 1)
        eng.save_checkpoint(d)
        retries = eng.resilience_report()["checkpoint"]["io_retries"]
        eng.shutdown()
        set_injector(None)
        ok, why = verify_tag_dir(os.path.join(d, "global_step1"))
        if retries != 2 or not ok:
            raise AssertionError(f"checkpoint (c) io_error: retries "
                                 f"{retries}, {why}")
        out["io_retries"] = retries
        # a nan_grads step is healed, params and moments unchanged by it
        eng = ckpt_tiny_engine(device, faults=[{"kind": "nan_grads",
                                                "step": 2}])
        tiny_steps(eng, 2)
        before = state_snapshot(eng)
        tiny_steps(eng, 1, seed=7)
        after = state_snapshot(eng)
        changed = [k for k in snapshots_equal(torch, after, before)
                   if k != "counters"]
        rep = eng.resilience_report()
        eng.shutdown()
        set_injector(None)
        if eng.skipped_steps != 1 or changed or \
                rep["guard"]["bad_steps_skipped"] != 1:
            raise AssertionError(f"checkpoint (c) nan_grads: skipped "
                                 f"{eng.skipped_steps}, changed {changed}")
        out["nan_skipped"] = eng.skipped_steps
        # SIGTERM -> a loadable emergency tag at the next boundary
        d = os.path.join(tmp, "preempt")
        eng = ckpt_tiny_engine(device)
        tiny_steps(eng, 1)
        eng.save_checkpoint(d)              # the manager + its handler
        if not eng._primary_mgr._preempt_handler_installed:
            raise AssertionError("checkpoint (c): no SIGTERM handler (not "
                                 "the main thread)")
        os.kill(os.getpid(), signal.SIGTERM)
        tiny_steps(eng, 1)                  # the boundary fires the save
        emergency = eng.resilience_report()["checkpoint"]["emergency_saves"]
        eng.shutdown()
        tags = [t for t in os.listdir(d) if t.startswith("preempt")]
        eng = ckpt_tiny_engine(device)
        path, _ = eng.load_checkpoint(d)
        resumed = tiny_steps(eng, 1, seed=3)
        eng.shutdown()
        if emergency != 1 or tags != ["preempt_step2"] or \
                not verify_tag_dir(os.path.join(d, tags[0]))[0] or \
                not path.endswith("preempt_step2") or \
                not np.isfinite(resumed[0]):
            raise AssertionError(f"checkpoint (c) SIGTERM: emergency "
                                 f"{emergency}, tags {tags}, path {path}")
        out["preempt"] = tags
        # a heartbeat with a short deadline reports no hang
        hb = os.path.join(tmp, "hb")
        eng = ckpt_tiny_engine(device, heartbeat={
            "enabled": True, "dir": hb, "interval_s": 0.05, "poll_s": 0.05,
            "deadline_s": CKPT_HB_DEADLINE_S,
            "collective_deadline_s": None})
        tiny_steps(eng, 3)
        time.sleep(0.2)                     # a few beats after the steps
        rep = eng.resilience_report()
        eng.shutdown()
        with open(os.path.join(hb, "heartbeat_0.json")) as f:
            beat = json.load(f)
        if rep["heartbeat"]["counters"]["hangs_detected"] or \
                rep["heartbeat"]["hang_detected"] or beat["step"] < 1:
            raise AssertionError(f"checkpoint (c) heartbeat: {rep} {beat}")
        out["heartbeat_step"] = beat["step"]
    finally:
        set_injector(None)
        with contextlib.suppress(ValueError):   # not the main thread
            signal.signal(signal.SIGTERM, prev_term)
    log(f"checkpoint (c) [{card}]: torn newest fell back "
        f"{out['torn']}; keep-last-K left {out['gc']}; io_error retried "
        f"{out['io_retries']} times and landed; nan_grads step skipped "
        f"({out['nan_skipped']}), params and moments unchanged; SIGTERM "
        f"gave {out['preempt']}, verified and loaded; heartbeat (deadline "
        f"{CKPT_HB_DEADLINE_S} s) no hang, last beat at step "
        f"{out['heartbeat_step']}")
    return out


def ckpt_serve(torch, a, device, card):
    """(e): ``init_inference(model, checkpoint=)`` against
    ``init_inference(model, params=)`` on A's params at the save; the
    consolidated fp32 masters and the 16-bit export's names."""
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.runtime.checkpoint import consolidate_to_fp32

    saved = {k[len("params/"):]: v for k, v in a["saved"].items()
             if k.startswith("params/")}
    flat = consolidate_to_fp32(a["ckpt"])
    if set(flat) != set(saved):
        raise AssertionError(f"checkpoint (e): consolidated names "
                             f"{sorted(set(flat) ^ set(saved))[:8]}")
    bad = [n for n, w in saved.items()
           if not np.array_equal(flat[n].view(np.uint32),
                                 w.float().numpy().view(np.uint32))]
    if bad:
        raise AssertionError(f"checkpoint (e): consolidated masters differ "
                             f"at {bad[:8]}")
    with np.load(a["fp16"]) as z:
        names16 = set(z.files)
    if names16 != set(saved):
        raise AssertionError(f"checkpoint (e): save_16bit_model names "
                             f"{sorted(names16 ^ set(saved))[:8]}")
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, a["V"], (1, n)).astype(np.int64)
               for n in CKPT_PROMPTS]
    model = a["model"]

    def tokens(**kw):
        eng = tds.init_inference(model, device=device, **kw)
        out = [eng.generate(p, max_new_tokens=CKPT_NEW)[0, p.shape[1]:]
               for p in prompts]
        del eng
        free_card(torch, device)
        return [t.tolist() for t in out]

    from deepspeed_tpu_torch.runtime.checkpoint import unflatten_tree

    got = tokens(checkpoint=a["ckpt"])
    want = tokens(params=unflatten_tree(saved))
    if [len(t) for t in got] != [CKPT_NEW] * len(prompts):
        raise AssertionError(f"checkpoint (e): generated {got}")
    if got != want:
        raise AssertionError(f"checkpoint (e): tokens from the checkpoint "
                             f"{got} != from params= {want}")
    log(f"checkpoint (e) [{card}]: init_inference(checkpoint=) greedy "
        f"tokens equal params= for prompts of {list(CKPT_PROMPTS)} "
        f"({CKPT_NEW} new tokens each): {got}; consolidate_to_fp32 equals "
        f"A's saved masters bit for bit ({len(flat)} names); "
        f"save_16bit_model wrote the same {len(names16)} names")
    return got


def checkpoint(torch, fa, KERNELS, reset_counts, device="cuda"):
    """Phase 13: engine checkpoints and the resilience layer -- (a) the
    round trip at phase 5's width (``CKPT_MODEL_KW``'s depth), (b) the
    async save, (c) the
    resilience drill on tiny engines, (d) crash and resume in subprocesses,
    (e) serving the checkpoint. Returns the phase's launches per kernel."""
    import shutil
    import tempfile
    import threading

    from deepspeed_tpu_torch.tools.crash_resume import check as check_drill
    from deepspeed_tpu_torch.tools.crash_resume import drill

    cuda = torch.device(device).type == "cuda"
    card = card_line() if cuda else device

    def sync():
        if cuda:
            torch.cuda.synchronize()

    free_card(torch, device)
    base = torch.cuda.memory_allocated() if cuda else 0
    threads = {t.ident for t in threading.enumerate()}
    tmp = tempfile.mkdtemp(prefix="dstpu_ckpt_")
    t_phase = time.perf_counter()
    try:
        reset_counts()
        with CheckpointReplay(torch, fa) as replay:
            replay.stage = "checkpoint"
            a = ckpt_roundtrip(torch, tmp, device, sync, card)
            replay.stage = None
            ckpt_async(torch, tmp, device, sync, card, a["bytes"])
            ckpt_drill(torch, tmp, device, card)
            t = time.perf_counter()
            result = drill(os.path.join(tmp, "crash"), device)
            check_drill(result)
            rep = result["run1"]["report"]
            log(f"checkpoint (d) [{card}]: exit codes "
                f"{result['exit_codes']}, run 1 resumed at step "
                f"{result['run1']['start_step']} and reached "
                f"{result['run1']['end_step']}; verify_failures "
                f"{rep['checkpoint']['verify_failures']}, load_fallbacks "
                f"{rep['checkpoint']['load_fallbacks']}, healed "
                f"{rep['guard']['bad_steps_skipped']} NaN step; "
                f"{(time.perf_counter() - t) * 1e3:.0f} ms")
            ckpt_serve(torch, a, device, card)
            del a
        counts = {k: v.launches for k, v in KERNELS.items() if v.launches}
        missing = [k for k in CKPT_KERNELS if not counts.get(k)]
        if missing:
            raise AssertionError(f"checkpoint: kernels never launched "
                                 f"{missing} (counts {counts})")
        errs = replay.check()
        del replay
        log(f"checkpoint: launches {counts}; captured launches replayed vs "
            f"plain, max abs err {errs}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    free_card(torch, device)
    now = torch.cuda.memory_allocated() if cuda else 0
    left = [t.name for t in threading.enumerate() if t.ident not in threads]
    log(f"checkpoint [{card}]: card memory {base} bytes before the phase, "
        f"{now} after; threads left {left}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    if now - base > CKPT_MEM_SLACK or left:
        raise AssertionError(f"checkpoint: {now - base} bytes of the card "
                             f"still held, threads left {left}")
    return counts


# ---------------------------------------------------------------------------
# phase 14: the rest of training -- remat policies, optimizers, LTD, PLD,
# the curriculum and the tiled loss on llama3-1b
# ---------------------------------------------------------------------------

FEAT_MODEL_KW: dict = {}       # overrides of phase 5's model (CPU tests)
FEAT_SEQ = None                # tokens a row (None: phase 5's TRAIN_SEQ)
FEAT_LTD_KEEP = 1000           # not a multiple of D's 64-row tile
FEAT_LTD_LAYERS = (1, 15)
FEAT_CURRICULUM = (256, 2048, 4)   # min, max difficulty, steps (bucket: min)
FEAT_PLD_TIERS = 4
FEAT_PLD_STEPS = 4
FEAT_PLD_GAMMA = 0.5           # theta 1 -> 0.80 -> 0.68 -> 0.61: depth moves
FEAT_OPT_STEPS = 3
# (name, learning rate): each optimizer's usual rate for a model this size
FEAT_OPTIMIZERS = (("lamb", 1e-3), ("lion", 1e-4), ("adagrad", 1e-1),
                   ("adafactor", 1e-2), ("rmsprop", 3e-5), ("muon", 2e-2))
FEAT_REMAT_REL = 1e-5          # per-leaf grads under a policy vs none's
FEAT_OPT_REL = 1e-5            # one update, card vs CPU
FEAT_MUON_REL = 2e-2           # muon's bf16 Newton-Schulz, card vs CPU
FEAT_TILED_LOSS_REL = 1e-3     # loss_tiling 8 vs 1: the loss
FEAT_TILED_GRAD_REL = 2e-2     # ... and the per-leaf grads
FEAT_LTD_REL = 2e-2            # an LTD layer, kernels vs plain attention


class FeatureTrainReplay(TrainReplay):
    """Phase 14's :class:`Replay`: the first launch of each of D, E and F
    at random-LTD's ``FEAT_LTD_KEEP`` rows (stage ``ltd``: D's ragged
    tail)."""

    REQUIRED = {(k, "ltd") for k in TRAIN_KERNELS}

    def _wanted(self, target, name, x) -> bool:
        return (self.stage is not None and x["q"].shape[1] == FEAT_LTD_KEEP
                and super()._wanted(target, name, x))


class attention_calls:
    """Counts the calls of kernel D's wrapper by query rows (one launch
    each on the card), wrapping the module attribute until exit."""

    def __init__(self, fa):
        self.fa, self.rows = fa, []

    def __enter__(self):
        fn = self.fa.flash_forward

        def counted(q, *a, **k):
            self.rows.append(int(q.shape[1]))
            return fn(q, *a, **k)

        counted.__wrapped__ = fn
        self.fa.flash_forward = counted
        return self

    def __exit__(self, *exc):
        self.fa.flash_forward = self.fa.flash_forward.__wrapped__

    def take(self) -> list:
        rows, self.rows = self.rows, []
        return rows


def feat_model(**kw):
    """Phase 5's model (``FEAT_MODEL_KW`` and ``kw`` applied)."""
    import dataclasses

    from deepspeed_tpu_torch import TransformerLM
    from deepspeed_tpu_torch.tools.train_profile import train_model_config

    return TransformerLM(dataclasses.replace(train_model_config(),
                                             **{**FEAT_MODEL_KW, **kw}))


def feat_config(**extra) -> dict:
    from deepspeed_tpu_torch.tools.train_profile import TRAIN_CONFIG

    return {**TRAIN_CONFIG, **extra}


def feat_batch(vocab: int) -> dict:
    from deepspeed_tpu_torch.tools.train_profile import (TRAIN_CONFIG,
                                                         TRAIN_SEQ)

    rng = np.random.default_rng(0)
    micro = TRAIN_CONFIG["train_micro_batch_size_per_gpu"]
    return {"input_ids": rng.integers(
        0, vocab, (micro, FEAT_SEQ or TRAIN_SEQ)).astype(np.int32)}


def leaf_rel(torch, got, want) -> float:
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


def update_rel(torch, p0, got, want):
    """(rel L2 of two updated fp32 leaves' difference over the CPU
    update's displacement, the same for one ulp of every updated
    element): two updates equal to within fp32's rounding of ``p + u``
    differ by at most the second number."""
    moved = (want.double() - p0.double()).norm().clamp_min(1e-300)
    ulp = torch.nextafter(want, torch.full_like(want, float("inf"))) - want
    return (float((got.double() - want.double()).norm() / moved),
            float(ulp.double().norm() / moved))


def feat_remat(torch, fa, ctx):
    """(a): one forward + backward per policy on the same parameters and
    micro-batch. Returns none's gradients and the engine's leaves."""
    import dataclasses

    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.runtime import activation_checkpointing as ac

    model = feat_model()
    cfg0 = model.cfg
    L = cfg0.num_layers
    eng, *_ = tds.initialize(model, feat_config(), device=ctx["device"])
    batch = ctx["batch"]
    keeps_attn = ("none", "attn_saveable", "dots_and_attn_saveable",
                  "offload_attn")
    eng.backward(eng.forward(batch))       # warm-up (allocator, cuBLAS)
    for p in eng._leaves:
        p.grad = None
    eng._grad_acc_count = 0
    ctx["take"]()
    ref, res = None, {}
    for policy in ac.POLICIES:
        eng.module.cfg = dataclasses.replace(cfg0, remat_policy=policy)
        ac.OFFLOAD_STATS.update(bytes=0, tensors=0)
        ctx["sync"]()
        base = ctx["allocated"]()
        ctx["reset_peak"]()
        ctx["calls"].take()
        t = time.perf_counter()
        eng.backward(eng.forward(batch))
        ctx["sync"]()
        ms = (time.perf_counter() - t) * 1e3
        peak = (ctx["peak"]() - base) / 1e9
        rows = ctx["calls"].take()
        launches = ctx["take"]()
        grads = [p.grad for p in eng._leaves]
        for p in eng._leaves:
            p.grad = None
        eng._grad_acc_count = 0
        if ref is None:
            ref = grads
        rel = max(leaf_rel(torch, g, w) for g, w in zip(grads, ref))
        bit = all(torch.equal(g, w) for g, w in zip(grads, ref))
        want = L if policy in keeps_attn else 2 * L
        res[policy] = dict(peak_gb=round(peak, 3), ms=round(ms, 1),
                           host_bytes=ac.OFFLOAD_STATS["bytes"], rel=rel,
                           bit_equal=bit, d_calls=len(rows),
                           d_launches=launches["flash_fwd"])
        log(f"train-features (a) [{ctx['card']}] {policy}: peak "
            f"{peak:.3f} GB above the start, host {ac.OFFLOAD_STATS['bytes']}"
            f" bytes, {ms:.1f} ms fwd+bwd, grads vs none max rel L2 "
            f"{rel:.3e}, bit-equal {bit}, D {len(rows)} calls / "
            f"{launches['flash_fwd']} launches (want {want})")
        if not rel <= FEAT_REMAT_REL:
            raise AssertionError(f"train-features (a): {policy} grads rel "
                                 f"L2 {rel} > {FEAT_REMAT_REL}")
        if len(rows) != want or (ctx["cuda"]
                                 and launches["flash_fwd"] != want):
            raise AssertionError(f"train-features (a): {policy} ran D "
                                 f"{len(rows)} times ({launches} launches)"
                                 f", want {want}")
        del grads
    if ctx["cuda"]:
        p = {k: v["peak_gb"] for k, v in res.items()}
        if not (p["full"] <= p["attn_saveable"] <= p["none"]
                and p["offload_attn"] < p["attn_saveable"]):
            raise AssertionError(f"train-features (a): peak order {p}")
        if not res["offload_attn"]["host_bytes"]:
            raise AssertionError("train-features (a): offload_attn sent "
                                 "nothing to the host")
    names = {"embed": ("embed", "tokens"), "wq": ("layers", "attn", "wq"),
             "ln1": ("layers", "ln1", "scale")}
    order = [n for n, _ in _walk(eng.params)]
    keep = {}
    for tag, path in names.items():
        i = order.index("/".join(path))
        keep[tag] = (eng._leaves[i].detach().clone(), ref[i].clone())
    del eng, ref
    free_card(torch, ctx["device"])
    return res, keep


def _walk(tree, prefix=""):
    for k in tree:
        v = tree[k]
        if isinstance(v, dict):
            yield from _walk(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def feat_optimizers(torch, ctx, leaves):
    """(b): each optimizer for ``FEAT_OPT_STEPS`` steps; one update of
    three real leaves on the card against the same update on the CPU."""
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.runtime.optimizers import build_optimizer

    res = {}
    for name, lr in FEAT_OPTIMIZERS:
        eng, *_ = tds.initialize(feat_model(), feat_config(optimizer={
            "type": name, "params": {"lr": lr}}), device=ctx["device"])
        losses, ms = [], []
        for _ in range(FEAT_OPT_STEPS):
            t = time.perf_counter()
            losses.append(eng.train_batch(itertools.repeat(ctx["batch"])))
            ctx["sync"]()
            ms.append(round((time.perf_counter() - t) * 1e3, 1))
        ctx["take"]()
        del eng
        free_card(torch, ctx["device"])
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"train-features (b): {name} losses "
                                 f"{losses}")
        rels = {}
        t = time.perf_counter()
        for tag, (p, g) in leaves.items():
            tx = build_optimizer(name, {"lr": lr})
            new = []
            for dev in (p.device, "cpu"):
                w = [p.to(dev, copy=True)]
                state = tx.init(w)
                tx.update(w, [g.to(dev, copy=True)], state)
                new.append(w[0].to(p.device))
            rels[tag] = update_rel(torch, p, *new)
            del new
        gate = FEAT_MUON_REL if name == "muon" else FEAT_OPT_REL
        res[name] = dict(lr=lr, losses=losses, step_ms=ms, update_rel=rels)
        log(f"train-features (b) [{ctx['card']}] {name} lr {lr}: losses "
            f"{losses}, step ms {ms}; one update of "
            f"{ {k: tuple(v[0].shape) for k, v in leaves.items()} } card vs "
            f"CPU (rel L2 over the displacement, fp32 rounding floor) "
            f"{rels} (gate {gate} + floor; "
            f"{(time.perf_counter() - t) * 1e3:.0f} ms)")
        bad = {k: r for k, r in rels.items() if not r[0] <= gate + r[1]}
        if bad:
            raise AssertionError(f"train-features (b): {name} update card "
                                 f"vs CPU rel L2 {bad} > {gate} + floor")
    return res


def ltd_layer_check(torch, fa, ctx, model):
    """An LTD layer's output with the kernels against the same layer
    through plain attention on the same kept rows."""
    from deepspeed_tpu_torch.models.transformer import (_layer_views,
                                                        ltd_block,
                                                        torch_dtype)

    cfg = model.cfg
    dev = ctx["device"]
    T = ctx["batch"]["input_ids"].shape[1]
    params = model.init(seed=0, device=dev)
    dt = torch_dtype(cfg.dtype)
    w = _layer_views(params["layers"], dt)(FEAT_LTD_LAYERS[0])
    g = torch.Generator(device=dev).manual_seed(14)
    x = torch.randn(ctx["batch"]["input_ids"].shape[0], T, cfg.hidden_size,
                    generator=g, device=dev).to(dt)
    pos = model.ltd_positions(3, FEAT_LTD_LAYERS[0], T, FEAT_LTD_KEEP).to(dev)
    with torch.no_grad():
        y, _ = ltd_block(x, w, cfg, model.freqs(dev), pos)
        with plain_attention(fa):
            want, _ = ltd_block(x, w, cfg, model.freqs(dev), pos)
    dropped = torch.ones(T, dtype=torch.bool, device=dev)
    dropped[pos] = False
    rel = leaf_rel(torch, y[:, pos], want[:, pos])
    same = torch.equal(y[:, dropped], x[:, dropped])
    del params
    return rel, same


def feat_data_efficiency(torch, fa, ctx):
    """(c): random-LTD, both PLD modes, the curriculum and the tiled
    loss."""
    import dataclasses

    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.models.spec import tree_leaves

    batch, calls, card = ctx["batch"], ctx["calls"], ctx["card"]
    ga = feat_config()["gradient_accumulation_steps"]
    T = batch["input_ids"].shape[1]
    res = {}

    def steps(eng, n, b=batch):
        out, ms, rows = [], [], []
        for _ in range(n):
            calls.take()
            t = time.perf_counter()
            out.append(eng.train_batch(itertools.repeat(b)))
            ctx["sync"]()
            ms.append(round((time.perf_counter() - t) * 1e3, 1))
            rows.append(calls.take())
        if not all(np.isfinite(out)):
            raise AssertionError(f"train-features (c): losses {out}")
        return out, ms, rows

    # random-LTD
    lo, hi = FEAT_LTD_LAYERS
    ltd = {"enabled": True, "data_routing": {"enabled": True, "random_ltd": {
        "enabled": True, "min_value": FEAT_LTD_KEEP, "max_value":
        FEAT_LTD_KEEP, "step_size": 0, "random_ltd_layer_start": lo,
        "random_ltd_layer_end": hi}}}
    model = feat_model()
    L = model.cfg.num_layers
    eng, *_ = tds.initialize(model, feat_config(data_efficiency=ltd),
                             device=ctx["device"])
    ctx["take"]()
    ctx["replay"].stage = "ltd"
    losses, ms, rows = steps(eng, 2)
    ctx["replay"].stage = None
    launches = ctx["take"]()
    n_ltd = hi - lo
    want = sorted([T] * (L - n_ltd) + [FEAT_LTD_KEEP] * n_ltd) * ga
    got = [sorted(r) for r in rows]
    base = PHASE_NOTES.get("train_step_ms")
    pred = (L - n_ltd + n_ltd * FEAT_LTD_KEEP / T) / L
    log(f"train-features (c) [{card}] random-LTD keep {FEAT_LTD_KEEP} of "
        f"{T} over layers [{lo}, {hi}): losses {losses}, step ms {ms} "
        f"(phase 5: {base}; predicted {pred:.3f} of phase 5's step), "
        f"D calls by rows {[len(r) for r in rows]} / launches "
        f"{launches}")
    if got != [sorted(want)] * 2 or (
            ctx["cuda"] and launches["flash_fwd"] != 2 * len(want)):
        raise AssertionError(f"train-features (c): LTD ran D at rows {got}, "
                             f"launches {launches}, want {sorted(want)} a "
                             "step")
    del eng
    free_card(torch, ctx["device"])
    rel, same = ltd_layer_check(torch, fa, ctx, model)
    ctx["reset_counts"]()      # the check's launches are a comparison
    log(f"train-features (c) [{card}] LTD layer {lo}: kept rows vs plain "
        f"attention rel L2 {rel:.3e} (gate {FEAT_LTD_REL}), dropped rows "
        f"equal to the input: {same}")
    if not (rel <= FEAT_LTD_REL and same):
        raise AssertionError(f"train-features (c): LTD layer rel {rel}, "
                             f"dropped rows unchanged {same}")
    res["ltd"] = dict(losses=losses, step_ms=ms, layer_rel=rel,
                      phase5_step_ms=base, predicted_share=pred)

    # progressive layer drop: compiled tiers, then gated
    pld = {"enabled": True, "theta": 0.5, "gamma": FEAT_PLD_GAMMA}
    no_wd = {"type": "AdamW", "params": {"lr": 1e-4}}
    eng, *_ = tds.initialize(feat_model(), feat_config(
        progressive_layer_drop={**pld, "compiled_tiers": FEAT_PLD_TIERS},
        optimizer=no_wd), device=ctx["device"])
    depths, counts = [], []
    for _ in range(FEAT_PLD_STEPS):
        out = steps(eng, 1)
        depths.append(eng.module._pld_depth)
        counts.append(len(out[2][0]))
    launches = ctx["take"]()
    log(f"train-features (c) [{card}] PLD compiled_tiers {FEAT_PLD_TIERS}:"
        f" depth a step {depths}, D calls a step {counts} (GA {ga}), "
        f"launches {launches}")
    if counts != [k * ga for k in depths] or len(set(depths)) < 2 or (
            ctx["cuda"] and launches["flash_fwd"] != sum(counts)):
        raise AssertionError(f"train-features (c): PLD tiers depth {depths}"
                             f" D calls {counts} launches {launches}")
    del eng
    free_card(torch, ctx["device"])
    eng, *_ = tds.initialize(feat_model(), feat_config(
        progressive_layer_drop=pld), device=ctx["device"])
    bits = []
    keep_fn = eng.module.pld_keep
    eng.module.pld_keep = lambda *a: bits.append(keep_fn(*a)) or bits[-1]
    kept, counts = [], []
    for _ in range(3):
        out = steps(eng, 1)
        kept.append(sum(bits))
        bits.clear()
        counts.append(len(out[2][0]))
    launches = ctx["take"]()
    log(f"train-features (c) [{card}] gated PLD: layers kept a step "
        f"(host draws) {kept}, D calls {counts}, launches {launches}")
    if counts != kept or (ctx["cuda"]
                          and launches["flash_fwd"] != sum(kept)):
        raise AssertionError(f"train-features (c): gated PLD kept {kept}, "
                             f"D calls {counts}, launches {launches}")
    res["pld"] = dict(depths=depths, gated_kept=kept)
    del eng
    free_card(torch, ctx["device"])

    # the curriculum
    lo_d, hi_d, n = FEAT_CURRICULUM
    cur = {"enabled": True, "data_sampling": {
        "enabled": True, "curriculum_learning": {
            "enabled": True, "min_difficulty": lo_d,
            "max_difficulty": hi_d, "schedule_config": {
                "total_curriculum_step": n, "difficulty_step": lo_d}}}}
    eng, *_ = tds.initialize(feat_model(), feat_config(data_efficiency=cur),
                             device=ctx["device"])
    diffs = []
    for _ in range(n + 1):
        diffs.append(eng.curriculum_difficulty())
        out = steps(eng, 1)
        if set(out[2][0]) != {diffs[-1]}:
            raise AssertionError(f"train-features (c): curriculum step "
                                 f"{len(diffs) - 1} ran D at rows "
                                 f"{set(out[2][0])}, want {diffs[-1]}")
    ctx["take"]()
    log(f"train-features (c) [{card}] curriculum {lo_d} -> {hi_d} over {n}"
        f" steps: difficulty a step {diffs} (D's rows followed)")
    if diffs[0] != lo_d or diffs[-1] != hi_d:
        raise AssertionError(f"train-features (c): curriculum {diffs}")
    res["curriculum"] = diffs
    del eng
    free_card(torch, ctx["device"])

    # the tiled loss: loss_tiling 8 against 1 on one batch
    model = feat_model()
    params = model.init(seed=0, device=ctx["device"])
    leaves = list(tree_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    ids = {"input_ids": torch.from_numpy(batch["input_ids"]).to(
        ctx["device"])}
    out = {}
    for tiles in (1, 8):
        m = dataclasses.replace(model.cfg, loss_tiling=tiles)
        ctx["sync"]()
        base_b = ctx["allocated"]()
        ctx["reset_peak"]()
        loss = type(model)(m).loss_fn(params, ids)
        grads = torch.autograd.grad(loss, leaves)
        ctx["sync"]()
        out[tiles] = (float(loss.detach()), grads,
                      (ctx["peak"]() - base_b) / 1e9)
        del loss
    ctx["take"]()
    lrel = abs(out[8][0] - out[1][0]) / abs(out[1][0])
    rels = {n: leaf_rel(torch, g, w) for (n, _), g, w in
            zip(_walk(params), out[8][1], out[1][1])}
    worst = max(rels, key=rels.get)
    grel = rels[worst]
    log(f"train-features (c) [{card}] loss_tiling 8 vs 1: loss {out[8][0]} "
        f"vs {out[1][0]} (rel {lrel:.2e}, gate {FEAT_TILED_LOSS_REL}), "
        f"grads max rel L2 {grel:.3e} at {worst} (embed/tokens "
        f"{rels['embed/tokens']:.3e}; gate {FEAT_TILED_GRAD_REL}), peak "
        f"{out[8][2]:.3f} vs {out[1][2]:.3f} GB above the start")
    if not (lrel <= FEAT_TILED_LOSS_REL and grel <= FEAT_TILED_GRAD_REL):
        raise AssertionError(f"train-features (c): tiled loss rel {lrel}, "
                             f"grads {grel}")
    if ctx["cuda"] and not out[8][2] < out[1][2]:
        raise AssertionError(f"train-features (c): tiled peak {out[8][2]} "
                             f"not below {out[1][2]}")
    res["tiled"] = dict(loss_rel=lrel, grad_rel=grel,
                        peak_gb={t: round(v[2], 3) for t, v in out.items()})
    del out, params, leaves
    free_card(torch, ctx["device"])
    return res


def train_features(torch, fa, KERNELS, reset_counts, device="cuda"):
    """Phase 14: the rest of training on llama3-1b at full width and depth
    with phase 5's batch -- (a) every remat policy, (b) six optimizers,
    (c) random-LTD, both PLD modes, the curriculum and the tiled loss.
    Returns the phase's launches per kernel (comparison runs excluded)."""
    cuda = torch.device(device).type == "cuda"
    totals = {k: 0 for k in TRAIN_KERNELS}

    def take():
        got = {k: KERNELS[k].launches for k in TRAIN_KERNELS}
        for k, v in got.items():
            totals[k] += v
        reset_counts()
        return got

    def sync():
        if cuda:
            torch.cuda.synchronize()

    ctx = dict(
        device=device, cuda=cuda, sync=sync, take=take,
        reset_counts=reset_counts, card=card_line() if cuda else device,
        allocated=(torch.cuda.memory_allocated if cuda else lambda: 0),
        peak=(torch.cuda.max_memory_allocated if cuda else lambda: 0),
        reset_peak=(torch.cuda.reset_peak_memory_stats if cuda
                    else lambda: None),
        batch=feat_batch(feat_model().cfg.vocab_size))
    free_card(torch, device)
    t_phase = time.perf_counter()
    reset_counts()
    with FeatureTrainReplay(torch, fa) as replay, \
            attention_calls(fa) as calls:
        ctx["replay"], ctx["calls"] = replay, calls
        t = time.perf_counter()
        remat, leaves = feat_remat(torch, fa, ctx)
        t_a = time.perf_counter() - t
        t = time.perf_counter()
        opts = feat_optimizers(torch, ctx, leaves)
        del leaves
        t_b = time.perf_counter() - t
        t = time.perf_counter()
        de = feat_data_efficiency(torch, fa, ctx)
        t_c = time.perf_counter() - t
    errs = replay.check()
    del replay
    missing = [k for k, v in totals.items() if not v] if cuda else []
    if missing:
        raise AssertionError(f"train-features: kernels never launched "
                             f"{missing} ({totals})")
    log(f"train-features: launches {totals}; captured launches at "
        f"{FEAT_LTD_KEEP} rows replayed vs plain, max abs err {errs}")
    log(f"train-features [{ctx['card']}]: (a) {t_a:.1f} s, (b) {t_b:.1f} s,"
        f" (c) {t_c:.1f} s, phase {time.perf_counter() - t_phase:.1f} s")
    PHASE_NOTES["train_features"] = dict(remat=remat, optimizers=opts, **de)
    return totals


# ---------------------------------------------------------------------------
# phase 15: MoE training -- mixtral-8x7b at full width on one card
# ---------------------------------------------------------------------------

MOE_PRESET = "mixtral-8x7b"
MOE_MODEL_KW = {"num_layers": 2}   # overrides of the preset (depth cut)
MOE_SEQ = 2048                 # tokens a row
MOE_MICRO = 2                  # rows a micro-batch (TRAIN_CONFIG's GA 2)
MOE_STEPS = 3                  # train_batch steps, then one fused step
MOE_BLOCK_REL = 2e-2           # (c): block outputs and grads, rel L2


class MoETrainReplay(TrainReplay):
    """Phase 15's :class:`Replay`: the first launch of each of D, E and F
    at Mixtral's attention (stage ``moe``)."""

    REQUIRED = {(k, "moe") for k in TRAIN_KERNELS}

    def _wanted(self, target, name, x) -> bool:
        return self.stage is not None and super()._wanted(target, name, x)


def moe_model(**kw):
    """``MOE_PRESET`` at ``MOE_SEQ`` with ``MOE_MODEL_KW`` and ``kw``."""
    from deepspeed_tpu_torch import TransformerLM, get_preset

    return TransformerLM(get_preset(MOE_PRESET, max_seq_len=MOE_SEQ,
                                    **{**MOE_MODEL_KW, **kw}))


def moe_batch(vocab: int, rows: int) -> dict:
    rng = np.random.default_rng(15)
    return {"input_ids": rng.integers(0, vocab, (rows, MOE_SEQ))
            .astype(np.int32)}


class RoutedPairs:
    """An expert-load tracker that keeps every report (one per MoE block
    a forward)."""

    def __init__(self):
        self.seen = []

    def observe(self, counts):
        self.seen.append(np.asarray(counts))


def moe_engine_run(torch, ctx, tag: str, **model_kw) -> dict:
    """(a)/(b): ``initialize`` the model with ``TRAIN_CONFIG``'s optimizer
    and clipping at micro ``MOE_MICRO``, ``MOE_STEPS`` ``train_batch``
    steps and one ``fused_train_step`` on one fixed batch (the first
    step's routed pairs counted); then, on the trained params, the aux
    loss and the routed pairs of one forward."""
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.models.spec import num_params
    from deepspeed_tpu_torch.moe import sharded_moe
    from deepspeed_tpu_torch.parallel.cost_model import ModelProfile
    from deepspeed_tpu_torch.tools.train_profile import TRAIN_CONFIG

    model = moe_model(**model_kw)
    cfg = model.cfg
    config = {**TRAIN_CONFIG, "train_micro_batch_size_per_gpu": MOE_MICRO}
    ga = config["gradient_accumulation_steps"]
    ctx["sync"]()
    ctx["reset_peak"]()
    t0 = time.perf_counter()
    eng, *_ = tds.initialize(model, config, device=ctx["device"])
    ctx["sync"]()
    n = num_params(eng.params)
    log(f"moe-train {tag}: {MOE_PRESET} D={cfg.hidden_size} "
        f"L={cfg.num_layers} E={cfg.num_experts} top-{cfg.top_k} "
        f"F={cfg.intermediate_size} H={cfg.num_heads}/{cfg.num_kv_heads} "
        f"V={cfg.vocab_size}, dispatch {cfg.moe_dispatch} kernel "
        f"{cfg.moe_kernel}: {n / 1e9:.3f}B params, built in "
        f"{time.perf_counter() - t0:.1f} s")
    batch = moe_batch(cfg.vocab_size, MOE_MICRO)
    losses, norms, step_s = [], [], []
    first = RoutedPairs()      # the first step's routing (seed-0 weights)
    for i in range(MOE_STEPS):
        sharded_moe.set_expert_tracker(first if i == 0 else None)
        t = time.perf_counter()
        try:
            losses.append(float(eng.train_batch(itertools.repeat(batch))))
        finally:
            sharded_moe.set_expert_tracker(None)
        ctx["sync"]()
        step_s.append(time.perf_counter() - t)
        norms.append(float(eng.get_global_grad_norm()))
    t = time.perf_counter()
    losses.append(float(eng.fused_train_step(
        {"input_ids": np.concatenate([batch["input_ids"]] * ga)})))
    ctx["sync"]()
    step_s.append(time.perf_counter() - t)
    norms.append(float(eng.get_global_grad_norm()))
    peak = ctx["peak"]() / 1e9
    # the trained model's aux loss and routed pairs on the batch
    pairs = RoutedPairs()
    sharded_moe.set_expert_tracker(pairs)
    try:
        with torch.no_grad():
            ids = torch.from_numpy(batch["input_ids"]).to(ctx["device"])
            _, aux = eng.module.hidden_states_and_aux(eng.params, ids)
            aux = float(aux)
    finally:
        sharded_moe.set_expert_tracker(None)
    S = MOE_MICRO * MOE_SEQ

    def dropped(reports):
        kept = [int(c.sum()) for c in reports]
        return kept, 1.0 - sum(kept) / (len(kept) * S * cfg.top_k)

    kept, drop = dropped(pairs.seen)
    kept0, drop0 = dropped(first.seen)
    steady = float(np.median(step_s[1:]))
    tokens = MOE_MICRO * ga * MOE_SEQ
    active = ModelProfile.from_transformer_config(cfg, seq=MOE_SEQ).active
    flops_per_token = 6 * active + 12 * cfg.num_layers * MOE_SEQ \
        * cfg.hidden_size
    tps = tokens / steady
    log(f"moe-train {tag} [{ctx['card']}]: losses {losses}, grad norms "
        f"{norms}, aux {aux:.6f} (coef {cfg.moe_aux_loss_coef}), routed "
        f"pairs kept a layer of {S * cfg.top_k}: first step (a block a "
        f"micro-batch) {kept0}, drop fraction {drop0:.4f}; after the last "
        f"{kept}, drop fraction {drop:.4f}; step ms {[round(s * 1e3, 1) for s in step_s]} "
        f"({MOE_STEPS} train_batch, then fused_train_step), median of the "
        f"last {len(step_s) - 1} {steady * 1e3:.1f} ms = {tps:.1f} tokens/s "
        f"({tokens} tokens/step), model-FLOPs share "
        f"{tps * flops_per_token / BF16_FLOPS_PER_S:.4f} of 989 TFLOP/s "
        f"({flops_per_token / 1e9:.3f} GFLOP/token on {active / 1e9:.3f}B "
        f"active of {n / 1e9:.3f}B params), peak {peak:.2f} GB")
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        raise AssertionError(f"moe-train {tag}: non-finite loss or grad "
                             f"norm {losses} {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"moe-train {tag}: last loss {losses[-1]} not "
                             f"below the first {losses[0]}")
    if not aux > 0:
        raise AssertionError(f"moe-train {tag}: aux loss {aux} not > 0")
    if len(kept) != cfg.num_layers or len(kept0) != ga * cfg.num_layers:
        raise AssertionError(f"moe-train {tag}: {len(kept0)} and "
                             f"{len(kept)} expert-load reports for "
                             f"{cfg.num_layers} layers")
    del eng
    free_card(torch, ctx["device"])
    return dict(losses=losses, grad_norms=norms, aux=aux, drop=drop,
                first_drop=drop0,
                step_ms=[round(s * 1e3, 1) for s in step_s],
                tokens_per_s=round(tps, 1), peak_gb=round(peak, 2),
                mfu=tps * flops_per_token / BF16_FLOPS_PER_S)


def moe_block_check(torch, ctx) -> dict:
    """(c) one MoE block of the model's width on 1 x ``MOE_SEQ`` tokens in
    bf16: grouped ``ragged`` vs ``padded`` (the same top-k indices; output
    and the grads of x, router and the three stacks), capacity at
    ``capacity_factor = E`` vs grouped, and two ragged launches bit for
    bit."""
    import dataclasses

    from deepspeed_tpu_torch.moe import sharded_moe

    cfg = moe_model().cfg
    dev, dt = ctx["device"], torch.bfloat16
    D, Fd, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    g = torch.Generator(device=dev).manual_seed(151)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)

    x0 = randn(1, MOE_SEQ, D)
    w0 = {"router": randn(D, E, scale=D ** -0.5),
          "w_gate": randn(E, D, Fd, scale=D ** -0.5),
          "w_up": randn(E, D, Fd, scale=D ** -0.5),
          "w_down": randn(E, Fd, D, scale=Fd ** -0.5)}
    dy = randn(1, MOE_SEQ, D)
    route = sharded_moe._route
    picks = []

    def spy(*a, **k):
        out = route(*a, **k)
        picks.append(out[3])
        return out

    def run(fn, c):
        x = x0.clone().requires_grad_(True)
        w = {n: t.clone().requires_grad_(True) for n, t in w0.items()}
        y, aux = fn(x, w, c)
        grads = torch.autograd.grad(y, [x, *w.values()], grad_outputs=dy)
        ctx["sync"]()
        return [y.detach(), *grads], float(aux.detach())

    names = ["out", "x", "router", "w_gate", "w_up", "w_down"]
    grouped = dataclasses.replace(cfg, moe_dispatch="grouped")
    sharded_moe._route = spy
    try:
        ragged, aux_r = run(sharded_moe.grouped_moe_mlp_block,
                            dataclasses.replace(grouped, moe_kernel="ragged"))
        padded, aux_p = run(sharded_moe.grouped_moe_mlp_block,
                            dataclasses.replace(grouped, moe_kernel="padded"))
    finally:
        sharded_moe._route = route
    again, _ = run(sharded_moe.grouped_moe_mlp_block,
                   dataclasses.replace(grouped, moe_kernel="ragged"))
    capacity, aux_c = run(sharded_moe.moe_mlp_block,
                          dataclasses.replace(cfg, capacity_factor=float(E)))
    res = {"same_topk": bool(torch.equal(picks[0], picks[1])),
           "ragged_vs_padded": {n: leaf_rel(torch, a, b) for n, a, b in
                                zip(names, ragged, padded)},
           "capacity_vs_grouped": {n: leaf_rel(torch, a, b) for n, a, b in
                                   zip(names, capacity, ragged)},
           "bit_identical": all(torch.equal(a, b)
                                for a, b in zip(ragged, again)),
           "aux": (aux_r, aux_p, aux_c)}
    log(f"moe-train (c) [{ctx['card']}]: one block, 1 x {MOE_SEQ} tokens "
        f"bf16: same top-k {res['same_topk']}, ragged vs padded rel L2 "
        f"{res['ragged_vs_padded']}, capacity (factor {E}) vs grouped "
        f"{res['capacity_vs_grouped']}, two ragged launches bit-identical "
        f"{res['bit_identical']}, aux {res['aux']}")
    bad = {k: {n: r for n, r in res[k].items() if not r <= MOE_BLOCK_REL}
           for k in ("ragged_vs_padded", "capacity_vs_grouped")}
    if not res["same_topk"] or any(bad.values()) or not res["bit_identical"]:
        raise AssertionError(f"moe-train (c): {res}")
    del ragged, padded, again, capacity, w0, x0
    free_card(torch, dev)
    return res


def moe_remat_check(torch, ctx) -> dict:
    """(c) the model's grads under remat ``full`` against ``none``'s, bit
    for bit, per dispatch; (d) the expert-load tracker installed for the
    ``full`` grouped run's forward and backward: each layer reports once,
    S * k routed pairs."""
    import dataclasses

    from deepspeed_tpu_torch.moe import sharded_moe

    out = {}
    ids = torch.from_numpy(moe_batch(moe_model().cfg.vocab_size, 1)
                           ["input_ids"]).to(ctx["device"])
    for dispatch in ("capacity", "grouped"):
        model = moe_model(moe_dispatch=dispatch)
        cfg0 = model.cfg
        params = model.init(seed=0, device=ctx["device"])
        leaves = [t.requires_grad_(True) for _, t in _walk(params)]
        ref, pairs = None, RoutedPairs()
        for policy in ("none", "full"):
            model.cfg = dataclasses.replace(cfg0, remat_policy=policy)
            track = dispatch == "grouped" and policy == "full"
            sharded_moe.set_expert_tracker(pairs if track else None)
            try:
                grads = torch.autograd.grad(
                    model.loss_fn(params, {"input_ids": ids}), leaves)
            finally:
                sharded_moe.set_expert_tracker(None)
            ctx["sync"]()
            if ref is None:
                ref = grads
        out[dispatch] = all(torch.equal(a, b) for a, b in zip(grads, ref))
        if dispatch == "grouped":
            out["tracker"] = [int(c.sum()) for c in pairs.seen]
        del params, leaves, grads, ref
        free_card(torch, ctx["device"])
    want = [MOE_SEQ * moe_model().cfg.top_k] * moe_model().cfg.num_layers
    log(f"moe-train (c) [{ctx['card']}]: grads under remat full bit-equal "
        f"to none's: capacity {out['capacity']}, grouped {out['grouped']}; "
        f"(d) tracker under full, routed pairs a layer {out['tracker']} "
        f"(want {want})")
    if not (out["capacity"] and out["grouped"]):
        raise AssertionError(f"moe-train (c): remat full grads differ from "
                             f"none's {out}")
    if out["tracker"] != want:
        raise AssertionError(f"moe-train (d): tracker counts "
                             f"{out['tracker']} != {want}")
    return out


def moe_train(torch, fa, KERNELS, reset_counts, device="cuda"):
    """Phase 15: MoE training on ``MOE_PRESET`` at full width (2 of its
    32 layers) -- (a) the capacity dispatch, (b) the grouped dispatch with
    the ragged product, each through ``initialize``; (c) one block's
    checks and the remat bit-equality; (d) the expert-load tracker.
    Returns the phase's launches per kernel."""
    cuda = torch.device(device).type == "cuda"
    totals = {k: 0 for k in TRAIN_KERNELS}

    def take():
        for k in TRAIN_KERNELS:
            totals[k] += KERNELS[k].launches
        reset_counts()

    ctx = dict(device=device, sync=(torch.cuda.synchronize if cuda
                                    else lambda: None),
               card=card_line() if cuda else device,
               peak=(torch.cuda.max_memory_allocated if cuda
                     else lambda: 0),
               reset_peak=(torch.cuda.reset_peak_memory_stats if cuda
                           else lambda: None))
    free_card(torch, device)
    t_phase = time.perf_counter()
    reset_counts()
    with MoETrainReplay(torch, fa) as replay:
        replay.stage = "moe"
        cap = moe_engine_run(torch, ctx, "(a) capacity")
        take()
        grp = moe_engine_run(torch, ctx, "(b) grouped", moe_dispatch="grouped",
                             moe_kernel="ragged")
        take()
        replay.stage = None
        block = moe_block_check(torch, ctx)
        remat = moe_remat_check(torch, ctx)
        take()
    errs = replay.check()
    del replay
    missing = [k for k, v in totals.items() if not v] if cuda else []
    if missing:
        raise AssertionError(f"moe-train: kernels never launched {missing} "
                             f"({totals})")
    log(f"moe-train: launches {totals}; first launches at {MOE_PRESET}'s "
        f"attention replayed vs plain, max abs err {errs}")
    log(f"moe-train [{ctx['card']}]: phase {time.perf_counter() - t_phase:.1f}"
        f" s")
    PHASE_NOTES["moe_train"] = dict(capacity=cap, grouped=grp, block=block,
                                    remat=remat)
    return totals


# ---------------------------------------------------------------------------
# phase 16: MoE serving -- mixtral-8x7b at full width, 8 of 32 layers
# ---------------------------------------------------------------------------

MOE_SERVE_KW = {"num_layers": 8}   # overrides of the preset (depth cut)
MOE_SERVE_CUT = 2              # (e): layers of the dense-engine cut
MOE_SERVE_STEPS = 32           # decode_batch steps
MOE_SERVE_REL_L2 = 2e-2        # cross-path and cross-engine logits
MOE_INT8_MAX_REL = 0.6         # (d): max |int8 - bf16| / max |bf16| logits
MOE_RECON_REL = 2e-2           # (d): a stack's dequant, of its max |w|
MOE_SERVE_ENGINE = dict(max_sequences=8, max_seq_len=2048, block_size=128)
MOE_SERVE_KERNELS = SERVE_KERNELS + ("qmm", "qmm_stacked",
                                     "paged_decode_int8", "paged_past_int8",
                                     "paged_tile")


class MoEServeReplay(Replay):
    """Phase 16's :class:`Replay` of kernels A-D: phase 4's stages, and no
    capture outside them (the cross-path puts)."""

    def _wanted(self, target, name, x) -> bool:
        return self.stage is not None and super()._wanted(target, name, x)


class RaggedSyncs:
    """Counts the calls of the grouped ragged product (``sharded_moe.
    _ragged_ffn``), each of which reads its group sizes on the host: one
    device-to-host sync an MoE layer a forward."""

    def __init__(self, sharded_moe):
        self.mod, self.calls = sharded_moe, 0

    def __enter__(self):
        real = self.mod._ragged_ffn

        def counted(*a, **k):
            self.calls += 1
            return real(*a, **k)

        counted.__wrapped__ = real
        self.mod._ragged_ffn = counted
        return self

    def __exit__(self, *exc):
        self.mod._ragged_ffn = self.mod._ragged_ffn.__wrapped__


class PinnedRouting:
    """Every MoE layer of ``model`` routes each row to experts fixed by
    the row's (position, token, layer) -- the same experts on every
    engine and batch layout -- with the router's own gates at them as
    combine weights, renormalised and masked by ``valid`` as ``_route``
    does. A random router's top-2 has near ties that bf16 noise between
    two batch layouts flips, and one flipped choice moves the logits far
    past 2e-2: with the choices pinned, a cross-path gate reads the
    attention, cache and expert-product paths alone. Wraps the model's
    five cached entry points and its full-sequence ``logits`` (each
    records its rows' positions and tokens) and ``sharded_moe._route``;
    restores both on exit."""

    ENTRIES = ("forward_with_cache", "forward_with_paged_cache",
               "forward_prefill", "forward_with_packed_cache",
               "forward_decode_tail", "logits")

    def __init__(self, torch, model, sharded_moe):
        self.torch, self.model, self.mod = torch, model, sharded_moe
        self.rows, self.layer = None, 0

    def _keys(self, name, a):
        """(positions, tokens) of the rows a forward routes, flattened as
        its MoE layers flatten them."""
        torch = self.torch
        ids = a[2]                      # a: the entry's arguments from self
        if name in ("forward_prefill", "logits"):
            pos = torch.arange(ids.shape[1], device=ids.device).expand_as(ids)
        elif name == "forward_with_packed_cache":
            pos = a[6]                                          # tok_pos
        elif name == "forward_decode_tail":
            pos = a[8] + a[5]                                   # pos_base + t
        else:            # forward_with_cache: cache["pos"]; paged: pos
            base = a[3]["pos"] if name == "forward_with_cache" else a[5]
            pos = base.long()[:, None] + torch.arange(ids.shape[1],
                                                      device=ids.device)
        return pos.reshape(-1).long(), ids.reshape(-1).long()

    def __enter__(self):
        torch = self.torch
        for name in self.ENTRIES:
            real = getattr(self.model, name)

            def entry(*a, _name=name, _real=real, **k):
                self.rows, self.layer = self._keys(_name, (None,) + a), 0
                return _real(*a, **k)

            setattr(self.model, name, entry)
        real_route = self.mod._route

        def route(logits, k, rng=None, noise_std=0.0, valid=None):
            gates, aux, _, _ = real_route(logits, k, rng, noise_std, valid)
            E = gates.shape[-1]
            if k > 2 or k >= E:
                raise ValueError(f"pinned routing takes top-1/2 of > 2 "
                                 f"experts, got top-{k} of {E}")
            pos, tok = self.rows
            h = (pos * 40503 + tok * 9973 + self.layer * 7919 + 12345) \
                % 1000003
            self.layer += 1
            e0 = h % E
            step = 1 + (h // E) % (E - 1)
            idx = torch.stack([(e0 + j * step) % E for j in range(k)], -1)
            vals = gates.gather(1, idx)
            vals = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
            if valid is not None:
                vals = vals * valid[:, None].to(vals.dtype)
            return gates, aux, vals, idx

        route.__wrapped__ = real_route
        self.mod._route = route
        return self

    def __exit__(self, *exc):
        self.mod._route = self.mod._route.__wrapped__
        for name in self.ENTRIES:
            vars(self.model).pop(name, None)


def drops_newest_past(fn):
    """A faulty kernel-B stand-in ((a)'s control): ``fn`` with each chunk
    atom's newest past token dropped."""
    def faulty(q, k_pool, v_pool, layer, block_tables, atom_slot, atom_pos0,
               tq, **kw):
        return fn(q, k_pool, v_pool, layer, block_tables, atom_slot,
                  atom_pos0 - 1, tq, **kw)
    return faulty


def moe_serve_model(**kw):
    """``MOE_PRESET`` cut to ``MOE_SERVE_KW``, bf16 parameters, the serve
    phases' ``max_seq_len``; grouped ragged dispatch unless ``kw`` says
    otherwise."""
    from deepspeed_tpu_torch import TransformerLM, get_preset

    kw = {"moe_dispatch": "grouped", "moe_kernel": "ragged",
          "param_dtype": "bfloat16",
          "max_seq_len": MOE_SERVE_ENGINE["max_seq_len"], **MOE_SERVE_KW,
          **kw}
    return TransformerLM(get_preset(MOE_PRESET, **kw))


def watch_tracker(eng):
    """``enable_metrics`` on ``eng`` (a fresh registry: its expert-load
    tracker installed) with each of the tracker's reports kept: the routed
    pairs of one MoE block (each report is one device-to-host copy)."""
    from deepspeed_tpu_torch.observability import MetricsRegistry

    eng.enable_metrics(registry=MetricsRegistry())
    tracker, reports = eng._moe_tracker, []
    real = tracker.observe

    def observe(counts):
        reports.append(int(np.asarray(counts).sum()))
        real(counts)

    tracker.observe = observe
    return reports


def moe_traffic(ctx, eng, prompts, steps: int = 0, mixed: bool = True,
                whole: bool = False, replay=None, stages=None):
    """Phase 4's traffic on ``eng``: the first prompts in one ``put``;
    with ``mixed`` a mixed ``put`` (a decode token of each beside the
    fresh prompts, chunked); with ``steps`` ``decode_batch`` of every uid;
    with ``whole`` the last fresh prompt put whole and the third first
    prompt put alone. Every uid is flushed at the end. With the tracker
    watched (:func:`watch_tracker`) each call's reports and ragged-product
    syncs are kept beside its real tokens, and its seconds (card
    synchronised)."""
    from deepspeed_tpu_torch.moe import sharded_moe

    firsts, fresh = prompts
    reports = ctx.get("reports")
    res = {"calls": {}, "seconds": {}}
    uids = list(range(len(firsts) + len(fresh)))

    def call(name, real, fn):
        if replay is not None:
            replay.stage = stages.get(name)
        if reports is not None:
            reports.clear()
        with RaggedSyncs(sharded_moe) as syncs:
            ctx["sync"]()
            t = time.perf_counter()
            out = fn()
            ctx["sync"]()
            res["seconds"][name] = time.perf_counter() - t
        res["calls"][name] = dict(real=real, syncs=syncs.calls,
                                  reports=None if reports is None
                                  else list(reports))
        return out

    V, n_first = eng.cfg.vocab_size, len(firsts)
    res["put"] = call("put", sum(map(len, firsts)),
                      lambda: eng.put(uids[:n_first], firsts))
    check_logits(res["put"], V)
    used = uids[:n_first]
    if mixed:
        nxt = [int(np.argmax(res["put"][u])) for u in used]
        res["mixed"] = call("mixed", n_first + sum(map(len, fresh)),
                            lambda: eng.put(uids, [np.array([x], np.int32)
                                                   for x in nxt]
                                            + list(fresh)))
        check_logits(res["mixed"], V)
        used = uids
    if steps:
        nxt = [int(np.argmax(res["mixed"][u])) for u in uids]
        res["decode"] = call("decode_batch", len(uids) * steps,
                             lambda: eng.decode_batch(uids, nxt,
                                                      steps=steps))
    if whole:
        u = len(uids)
        res["whole"] = call("whole", len(fresh[-1]),
                            lambda: eng.put([u], [fresh[-1]]))[u]
        res["alone"] = call("alone", len(firsts[2]),
                            lambda: eng.put([u + 1], [firsts[2]]))[u + 1]
        used = used + [u, u + 1]
    eng.flush(used)
    return res


def warm_up(ctx, eng, prompts, steps: int, mixed: bool = True) -> None:
    """The engine's traffic once before its timed run (its first calls
    pay one-time costs at each new shape), decode cut to 2 steps."""
    moe_traffic(ctx, eng, prompts, min(steps, 2), mixed=mixed)


def cross_path(prompts, res) -> tuple:
    """(the last fresh prompt's chunked vs whole-prompt logits, the third
    first prompt's in the batch vs alone), rel L2."""
    return (rel_l2(res["mixed"][len(prompts[0]) + len(prompts[1]) - 1],
                   res["whole"]),
            rel_l2(res["put"][2], res["alone"]))


def put_rel(res, ref) -> float:
    """The largest rel L2 of a first-prompts ``put``'s logits vs ``ref``'s."""
    return max(rel_l2(res["put"][u], ref["put"][u]) for u in ref["put"])


def check_pairs(tag: str, res, k: int, L: int, exact: bool) -> dict:
    """Each call's routed pairs (the tracker's reports) against its real
    tokens x ``k`` x ``L``: equal (``exact``, dropless) or at most that
    (capacity: drops). Returns {call: (pairs, real x k x L, reports)}."""
    out = {}
    for name, c in res["calls"].items():
        want = c["real"] * k * L
        got = sum(c["reports"])
        out[name] = (got, want, len(c["reports"]))
        if not c["reports"] or (got != want if exact else got > want):
            raise AssertionError(f"moe-serve {tag}: {name} routed {got} "
                                 f"pairs in {len(c['reports'])} reports, "
                                 f"real tokens x {k} x {L} = {want}")
    return out


def moe_engine_line(ctx, tag: str, eng, res, prompts, peak: float,
                    built_s: float) -> str:
    firsts, fresh = prompts
    sec = res["seconds"]
    parts = [f"moe-serve {tag} [{ctx['card']}]: prompt put "
             f"{sum(map(len, firsts)) / sec['put']:.1f} tokens/s "
             f"({sec['put'] * 1e3:.1f} ms)"]
    for name, what in (("mixed", "mixed put"),
                       ("decode_batch", "decode_batch")):
        if name in sec:
            n = res["calls"][name]["real"]
            parts.append(f"{what} {n / sec[name]:.1f} tokens/s ({n} "
                         f"tokens, {sec[name] * 1e3:.1f} ms)")
    parts.append(f"served tree {tree_bytes(eng.params) / 1e9:.3f} GB, "
                 f"peak {peak:.2f} GB, built in {built_s:.1f} s")
    parts.append("ragged-product host syncs " + str(
        {n: c["syncs"] for n, c in res["calls"].items()}))
    return "; ".join(parts)


def stack_reconstruction(torch, tree, qtree) -> dict:
    """(d): each layer's int8 expert stack dequantized (``_expert_weight``)
    against the dense stack it came from: max abs error / max |w|."""
    from deepspeed_tpu_torch.moe import sharded_moe

    mlp, qmlp = tree["layers"]["mlp"], qtree["layers"]["mlp"]
    worst = {}
    for name in ("w_gate", "w_up", "w_down"):
        for i in range(mlp[name].shape[0]):
            w = mlp[name][i]
            r = sharded_moe._expert_weight(
                {name + "_q": qmlp[name + "_q"][i],
                 name + "_s": qmlp[name + "_s"][i]}, name, w.dtype)
            rel = float((r.float() - w.float()).abs().max()
                        / w.float().abs().max())
            worst[name] = max(worst.get(name, 0.0), rel)
            del r
    return worst


def moe_serve(torch, pa, fa, qm, KERNELS, reset_counts, device="cuda",
              prompts=None, steps: int = MOE_SERVE_STEPS, max_atom=None,
              engine_kw=None, **model_kw):
    """Phase 16: MoE serving on ``MOE_PRESET`` at full width, cut to
    ``MOE_SERVE_KW``'s layers, seed-0 weights drawn on the card at the
    init scale, phase 4's traffic. (a) the packed engine,
    grouped ``ragged``, tracker on; (b) ``moe_kernel="padded"``; (c) the
    capacity dispatch, and at ``capacity_factor`` E (nothing drops); (d)
    int8 weights and pool; (e) the dense-tile engines and v1 at
    ``MOE_SERVE_CUT`` layers against the packed engine. Cross-path and
    cross-engine logits are gated under :class:`PinnedRouting` and
    printed free-running beside; each gate of (a) and (e) has a control
    that drops the newest past token. Returns the phase's launches per
    kernel.
    ``device``, ``prompts``, ``steps``, ``max_atom``, ``engine_kw`` and
    ``model_kw`` size it down for the CPU."""
    import dataclasses

    from deepspeed_tpu_torch import InferenceEngineV2, TransformerLM
    from deepspeed_tpu_torch.models.transformer import QuantizedWeight
    from deepspeed_tpu_torch.moe import sharded_moe

    cuda = torch.device(device).type == "cuda"
    kw = dict(engine_kw or MOE_SERVE_ENGINE, device=device)
    totals = dict.fromkeys(MOE_SERVE_KERNELS, 0)

    def take():
        for k in MOE_SERVE_KERNELS:
            totals[k] += KERNELS[k].launches
        reset_counts()

    ctx = dict(device=device, sync=(torch.cuda.synchronize if cuda
                                    else lambda: None),
               card=card_line() if cuda else device)
    peak = (lambda: torch.cuda.max_memory_allocated() / 1e9) if cuda \
        else (lambda: 0.0)

    def reset_peak():
        free_card(torch, device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()

    def gate(tag, rels):
        bad = {n: r for n, r in rels.items() if not r <= MOE_SERVE_REL_L2}
        if bad:
            raise AssertionError(f"moe-serve {tag}: rel L2 {bad} over "
                                 f"{MOE_SERVE_REL_L2} (pinned routing)")

    def pinned(m):
        return PinnedRouting(torch, m, sharded_moe)

    free_card(torch, device)
    t_phase = time.perf_counter()
    model = moe_serve_model(**model_kw)
    cfg = model.cfg
    if max_atom:
        model.MAX_ATOM = max_atom
    k, L, E = cfg.top_k, cfg.num_layers, cfg.num_experts
    prompts = prompts or serve_prompts(cfg.vocab_size)
    t = time.perf_counter()
    tree = model.init(seed=0, device=device)
    ctx["sync"]()
    t_tree = time.perf_counter() - t
    stacks = [tree["layers"]["mlp"][n] for n in ("w_gate", "w_up", "w_down")]
    expert_b = sum(w.nbytes for w in stacks)
    expert_n = sum(w.numel() for w in stacks)
    log(f"moe-serve: {MOE_PRESET} D={cfg.hidden_size} F="
        f"{cfg.intermediate_size} E={E} top-{k} H={cfg.num_heads}/"
        f"{cfg.num_kv_heads} V={cfg.vocab_size}, {L} of 32 layers: "
        f"{cfg.param_dtype} tree {tree_bytes(tree) / 1e9:.3f} GB (experts "
        f"{expert_b / 1e9:.3f} GB, {expert_b / L / 1e9:.3f} GB a layer; "
        f"their int8 copy {expert_n / 1e9:.3f} GB), drawn in {t_tree:.1f} s")
    del stacks
    res = {}
    reset_counts()

    # (a) packed, grouped ragged, tracker on
    reset_peak()
    t = time.perf_counter()
    eng = InferenceEngineV2(model, tree, **kw)
    built = time.perf_counter() - t
    warm_up(ctx, eng, prompts, steps)
    ctx["reports"] = watch_tracker(eng)
    try:
        with MoEServeReplay(torch, pa, fa) as replay:
            a = moe_traffic(ctx, eng, prompts, steps, whole=True,
                            replay=replay,
                            stages={"put": "put", "mixed": "put",
                                    "decode_batch": "decode_batch"})
        a["peak"] = peak()
        a["pairs"] = check_pairs("(a)", a, k, L, exact=True)
        if cuda:
            dec = [np.array([int(np.argmax(a["put"][u]))], np.int32)
                   for u in range(len(prompts[0]))]
            uids = list(range(len(dec)))
            eng.put(uids, prompts[0])
            on = step_launches(torch, lambda: eng.put(uids, dec))
            sharded_moe.set_expert_tracker(None)
            off = step_launches(torch, lambda: eng.put(uids, dec))
            a["launches_per_decode_put"] = {"tracker on": on,
                                            "tracker off": off}
            eng.flush(uids)
    finally:
        sharded_moe.set_expert_tracker(None)
        ctx["reports"] = None
    with pinned(model):
        a["pinned"] = moe_traffic(ctx, eng, prompts, whole=True)
        take()
        with swapped(pa, "past_partials", drops_newest_past):
            a["control"] = cross_path(prompts, moe_traffic(
                ctx, eng, prompts, whole=True))[0]
        reset_counts()
    a["replay"] = replay.check()
    a["free"] = cross_path(prompts, a)
    a["gated"] = cross_path(prompts, a["pinned"])
    log(moe_engine_line(ctx, "(a) grouped ragged", eng, a, prompts,
                        a["peak"], built))
    log(f"moe-serve (a): {len(prompts[1][-1])}-token prompt chunked vs "
        f"whole, and the {len(prompts[0][2])}-token prompt in the batch vs "
        f"alone, rel L2: pinned routing {a['gated']} (gate "
        f"{MOE_SERVE_REL_L2}), free-running {a['free']} (no gate: bf16 "
        f"noise can flip a near-tie top-2 choice); control (chunk atoms "
        f"drop their newest past token, pinned) chunked vs whole "
        f"{a['control']:.3e} (past {DENSE_CONTROL_MARGIN} x the gate); "
        f"routed pairs (got, real x "
        f"{k} x {L}, reports) {a['pairs']}; replayed first launches vs "
        f"plain, max abs err {a['replay']}; device launches of a "
        f"{len(prompts[0])}-sequence decode put "
        f"{a.get('launches_per_decode_put')}")
    gate("(a)", dict(zip(("chunked vs whole", "alone vs batched"),
                         a["gated"])))
    gate_controls("moe-serve (a)", {"chunked": a["control"]},
                  {"chunked": MOE_SERVE_REL_L2}, DENSE_CONTROL_MARGIN)
    del eng, replay
    res["a"] = a

    # (b) the padded twin of the grouped product
    reset_peak()
    t = time.perf_counter()
    eng = InferenceEngineV2(model, tree, moe_kernel="padded", **kw)
    built = time.perf_counter() - t
    warm_up(ctx, eng, prompts, 0, mixed=False)
    b = moe_traffic(ctx, eng, prompts, mixed=False)
    b["peak"] = peak()
    with pinned(model):
        b["pinned"] = moe_traffic(ctx, eng, prompts, mixed=False)
    take()
    b["free"] = put_rel(b, a)
    b["rel"] = put_rel(b["pinned"], a["pinned"])
    log(moe_engine_line(ctx, "(b) grouped padded", eng, b, prompts,
                        b["peak"], built))
    log(f"moe-serve (b): prompt put logits vs (a)'s, largest rel L2: "
        f"pinned routing {b['rel']:.3e} (gate {MOE_SERVE_REL_L2}), "
        f"free-running {b['free']:.3e}")
    if eng.moe_kernel != "padded":
        raise AssertionError(f"moe-serve (b): kernel {eng.moe_kernel}")
    gate("(b)", {"padded vs ragged": b["rel"]})
    del eng
    res["b"] = b

    # (c) the capacity dispatch, then at capacity_factor E (dropless)
    for tag, cf in (("(c)", cfg.capacity_factor),
                    ("(c) at factor E", float(E))):
        cmodel = TransformerLM(dataclasses.replace(
            cfg, moe_dispatch="capacity", capacity_factor=cf))
        cmodel.MAX_ATOM = model.MAX_ATOM
        reset_peak()
        t = time.perf_counter()
        eng = InferenceEngineV2(cmodel, tree, **kw)
        built = time.perf_counter() - t
        dropless = cf == E
        warm_up(ctx, eng, prompts, 0 if dropless else steps,
                mixed=not dropless)
        ctx["reports"] = watch_tracker(eng)
        try:
            with contextlib.ExitStack() as stack:
                if dropless:
                    stack.enter_context(pinned(cmodel))
                c = moe_traffic(ctx, eng, prompts, 0 if dropless else steps,
                                mixed=not dropless)
        finally:
            sharded_moe.set_expert_tracker(None)
            ctx["reports"] = None
        c["peak"] = peak()
        take()
        c["pairs"] = check_pairs(tag, c, k, L, exact=dropless)
        got = sum(p[0] for p in c["pairs"].values())
        want = sum(p[1] for p in c["pairs"].values())
        c["drop"] = 1.0 - got / want
        c["rel"] = put_rel(c, a["pinned"] if dropless else a)
        log(moe_engine_line(ctx, f"{tag} capacity {cf}", eng, c, prompts,
                            c["peak"], built))
        log(f"moe-serve {tag}: drop fraction over real tokens {c['drop']:.4f}"
            f"; routed pairs (got, real x {k} x {L}, reports) {c['pairs']}; "
            f"prompt put logits vs (a)'s, largest rel L2 {c['rel']:.3e}"
            + (f" (pinned routing, gate {MOE_SERVE_REL_L2})" if dropless
               else " (free-running; no gate: drops)"))
        if dropless:
            gate(tag, {"capacity vs grouped": c["rel"]})
        del eng
        res[tag] = c

    # (d) int8 weights (int8 expert pairs, G/H elsewhere) over an int8 pool
    reset_peak()
    t = time.perf_counter()
    eng = InferenceEngineV2(model, tree, weight_dtype="int8",
                            kv_dtype="int8", **kw)
    built = time.perf_counter() - t
    mlp = eng.params["layers"]["mlp"]
    names = sorted(mlp)
    bad = [n for n in names if n != "router" and not (
        n.endswith(("_q", "_s")) and (mlp[n].dtype == torch.int8)
        == n.endswith("_q"))]
    if bad or "w_gateup" in mlp or not isinstance(
            eng.params["layers"]["attn"]["wqkv"], QuantizedWeight):
        raise AssertionError(f"moe-serve (d): expert leaves {names}")
    recon = stack_reconstruction(torch, tree, eng.params)
    warm_up(ctx, eng, prompts, steps)
    with QuantReplay(torch, pa, qm, 8) as qreplay:
        d = moe_traffic(ctx, eng, prompts, steps, replay=qreplay,
                        stages={"put": "put", "mixed": "mixed",
                                "decode_batch": "decode_batch"})
    d["peak"] = peak()
    take()
    d["replay"] = qreplay.check()
    d["max_rel"] = max(float(np.abs(d["put"][u] - a["put"][u]).max()
                             / np.abs(a["put"][u]).max()) for u in a["put"])
    log(moe_engine_line(ctx, "(d) int8 weights, int8 pool", eng, d, prompts,
                        d["peak"], built))
    log(f"moe-serve (d): expert leaves {names}; stacks' dequant max abs err "
        f"/ max |w| {recon} (gate {MOE_RECON_REL}); prompt put logits vs "
        f"(a)'s, largest max-relative {d['max_rel']:.3e} (gate "
        f"{MOE_INT8_MAX_REL}: a random router flips top-2 under int8 noise)"
        f"; replayed first launches vs plain, max abs err {d['replay']}")
    if max(recon.values()) > MOE_RECON_REL \
            or not d["max_rel"] <= MOE_INT8_MAX_REL:
        raise AssertionError(f"moe-serve (d): dequant {recon}, logits "
                             f"max-relative {d['max_rel']}")
    del eng, mlp, qreplay
    res["d"] = d

    # (e) the dense-tile engines and v1 at MOE_SERVE_CUT layers: phase 7's
    # cross-check, on a seed-0 tree of that depth as there
    del tree
    free_card(torch, device)
    cut = min(MOE_SERVE_CUT, L)
    model2 = moe_serve_model(**{**model_kw, "num_layers": cut})
    tree2 = model2.init(seed=0, device=device)
    rng = np.random.default_rng(2)
    v1_ids = [rng.integers(1, cfg.vocab_size, 128).astype(np.int32)
              for _ in range(4)]
    e_kw = {n: v for n, v in kw.items() if n != "device"}
    free = dense_runs(torch, pa, model2, tree2, prompts[0], v1_ids, 4,
                      device=device, **e_kw)["rel"]
    with pinned(model2):
        e = dense_runs(torch, pa, model2, tree2, prompts[0], v1_ids, 4,
                       device=device, **e_kw)
        take()
        e["faulty"] = dense_controls(torch, pa, model2, tree2, prompts[0],
                                     e.pop("ref"), device=device, **e_kw)
    reset_counts()
    e["free"] = free
    limits = dict.fromkeys(("forward", "a", "b", "c"), MOE_SERVE_REL_L2)
    log(f"moe-serve (e) at {cut} layers: logits vs the packed engine, rel "
        f"L2: pinned routing {e['rel']} (gate {MOE_SERVE_REL_L2}), "
        f"free-running {free}; controls (newest column dropped, pinned) "
        f"{e['faulty']} (past {DENSE_CONTROL_MARGIN} x the gate); I's first "
        f"launch replayed, max abs err {e['replay']}")
    gate_rel("moe-serve (e)", e["rel"], limits)
    gate_controls("moe-serve (e)", e["faulty"], limits, DENSE_CONTROL_MARGIN)
    res["e"] = e
    del tree2
    free_card(torch, device)
    missing = [n for n, c in totals.items() if not c] if cuda else []
    if missing:
        raise AssertionError(f"moe-serve: kernels never launched {missing} "
                             f"({totals})")
    log(f"moe-serve: launches {totals}")
    log(f"moe-serve [{ctx['card']}]: phase {time.perf_counter() - t_phase:.1f}"
        f" s")
    PHASE_NOTES["moe_serve"] = res
    return totals


# ---------------------------------------------------------------------------
# phase 17: offload -- ZeRO-Offload on one card (host Adam, NVMe tier,
# ZenFlow), llama3-1b at full width and depth, llama3-8b cut in depth
# ---------------------------------------------------------------------------

OFFLOAD_STEPS = 3              # steps of (a), (b)'s top-k run and (d)
OFFLOAD_ADAM_N = 1 << 24       # (a) 1: elements of the flat buffers
OFFLOAD_ADAM_TOL = dict(rtol=1e-5, atol=1e-6)  # host Adam vs plain twin
OFFLOAD_LOSS_RTOL = 5e-3       # (a) 3: steps 2-3 vs the on-card AdamW
OFFLOAD_FIRST_RTOL = 1e-6      # (b): overlap's first two losses
OFFLOAD_SHIFT_RTOL = 2e-2      # (b): overlap vs sync, shifted one step
OFFLOAD_TOPK = {"topk_ratio": 0.1, "update_interval": 2,
                "select_interval": 4}
OFFLOAD_TOPK_LEAF = "layers/attn/wo"
OFFLOAD_NVME_LAYERS = 2        # (c): llama3-1b cut to 2 of 16 layers
OFFLOAD_NVME_STEPS = 2
OFFLOAD_MODEL_KW = {}          # overrides of both presets (the CPU test)
OFFLOAD_SEQ = None             # tokens a row (None: phase 5's TRAIN_SEQ)
OFFLOAD_BIG = "llama3-8b"      # (d): the model on-card AdamW cannot hold
# (d)'s depth: the host holds 16 B a param (fp32 masters, m, v and the
# page-locked grad buffers); the card's machine has 108 GB of RAM (~80 GB
# available by (d) in the whole script), so 32 layers (7.50B params, 120
# GB) do not fit, 16 (4.02B, 64.2 GB) do
OFFLOAD_BIG_LAYERS = 16
OFFLOAD_BIG_MICRO = 2          # rows a micro-batch of (d) (GA 2)


def offload_model(name: str = None, **kw):
    """``name`` (phase 5's preset by default) at ``OFFLOAD_SEQ`` with
    ``OFFLOAD_MODEL_KW`` and ``kw``."""
    from deepspeed_tpu_torch import TransformerLM, get_preset
    from deepspeed_tpu_torch.tools.train_profile import (TRAIN_PRESET,
                                                         TRAIN_SEQ)

    return TransformerLM(get_preset(
        name or TRAIN_PRESET, max_seq_len=OFFLOAD_SEQ or TRAIN_SEQ,
        **{**OFFLOAD_MODEL_KW, **kw}))


def offload_config(device: str = "cpu", zenflow=None, aio=None,
                   nvme_path=None, **extra) -> dict:
    """Phase 5's ``TRAIN_CONFIG`` (with ``extra``) and the optimizer on
    ``device`` (None: on the card)."""
    from deepspeed_tpu_torch.tools.train_profile import TRAIN_CONFIG

    config = {**TRAIN_CONFIG, **extra}
    if device is not None:
        off = {"device": device}
        if nvme_path:
            off["nvme_path"] = nvme_path
        config["zero_optimization"] = {"offload_optimizer": off}
        if zenflow:
            config["zero_optimization"]["zenflow"] = zenflow
        if aio:
            config["offload"] = {"aio": aio}
    return config


def offload_batch(vocab: int, rows: int = None) -> dict:
    """Phase 5's ``fixed_batch`` cut to ``OFFLOAD_SEQ`` columns and
    ``rows`` rows."""
    from deepspeed_tpu_torch.tools.train_profile import fixed_batch

    ids = fixed_batch(vocab)["input_ids"]
    return {"input_ids": np.ascontiguousarray(
        ids[:rows, :OFFLOAD_SEQ or ids.shape[1]])}


def host_gb(field: str, path: str = "/proc/self/status") -> float:
    """A ``kB`` field of ``/proc/self/status`` (VmRSS, VmHWM) or
    ``/proc/meminfo`` (MemAvailable), in GB."""
    with open(path) as f:
        for line in f:
            if line.startswith(field + ":"):
                return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def openmp_runtimes() -> list:
    """The OpenMP runtime libraries mapped into this process (torch's
    bundled one and the one ``csrc/cpu_adam.cpp``'s ``-fopenmp`` links)."""
    with open("/proc/self/maps") as f:
        return sorted({line.split()[-1] for line in f
                       if re.search(r"lib(g|i)?omp[^/]*\.so", line)})


def offload_steps(ctx, eng, batch, n: int) -> dict:
    """``n`` steps of ``eng`` on ``batch`` (GA micro-steps, then
    ``step()``; the card synchronised around each part): losses (mean of
    a step's micro-losses), grad norms, fwd+bwd ms, step() ms, and the
    offload report after each step."""
    ga = eng.gradient_accumulation_steps()
    out = {k: [] for k in ("losses", "norms", "fwd_bwd_ms", "opt_ms",
                           "split")}
    for _ in range(n):
        ctx["sync"]()
        t0 = time.perf_counter()
        losses = []
        for _ in range(ga):
            loss = eng.forward(batch)
            eng.backward(loss)
            losses.append(float(loss.detach()))
        ctx["sync"]()
        t1 = time.perf_counter()
        eng.step()
        ctx["sync"]()
        t2 = time.perf_counter()
        out["losses"].append(float(np.mean(losses)))
        out["norms"].append(eng.get_global_grad_norm())
        out["fwd_bwd_ms"].append(round((t1 - t0) * 1e3, 1))
        out["opt_ms"].append(round((t2 - t1) * 1e3, 1))
        rep = eng.offload_report()
        if rep["enabled"]:
            out["split"].append({k: rep[f"last_{k}_ms"]
                                 for k in ("d2h", "adam", "upload")})
    return out


def stale_steps(ctx, eng, batch, n: int, after_first=None) -> list:
    """ZenFlow overlap's trajectory replayed on a synchronous engine: step
    k's update takes the gradient of step k-1's forward (step 0's its
    own), as an overlapped step's host Adam reads a gradient one step
    stale. Returns the losses, which equal an ``overlap_step`` run's from
    its second step on, bit for bit; ``after_first()`` runs after step 0,
    a plain synchronous step."""
    ga = eng.gradient_accumulation_steps()
    losses, prev = [], None
    for k in range(n):
        step = []
        for _ in range(ga):
            loss = eng.forward(batch)
            eng.backward(loss)
            step.append(float(loss.detach()))
        # a copy: the step divides the accumulated .grad in place
        fresh = [p.grad.detach().to("cpu", copy=True) for p in eng._leaves]
        if prev is not None:
            for p, g in zip(eng._leaves, prev):
                p.grad = g.to(p.device)
        eng.step()
        ctx["sync"]()
        prev = fresh
        losses.append(float(np.mean(step)))
        if k == 0 and after_first is not None:
            after_first()
    return losses


def masters_equal_params(torch, eng) -> list:
    """Leaves whose param on the device differs from its host master."""
    from deepspeed_tpu_torch.runtime.checkpoint import flatten_tree

    off = eng._offload
    return [n for n, p in flatten_tree(eng.params).items()
            if not torch.equal(p.detach().cpu(),
                               off.master[f"{n}#0"].view(p.shape))]


def host_tier(eng) -> dict:
    """Own copies of the host optimizer's masters and moments."""
    return {k: np.array(v, copy=True)
            for k, v in eng._offload.state_dict().items()}


def offload_adam_check(torch, ctx) -> dict:
    """(a) 1: the host Adam on flat fp32 buffers against its plain twin on
    the same buffers, 3 steps at ``TRAIN_CONFIG``'s AdamW."""
    from deepspeed_tpu_torch.offload.cpu_adam import (DeepSpeedCPUAdam,
                                                      adam_step_plain)
    from deepspeed_tpu_torch.tools.train_profile import TRAIN_CONFIG

    kw = dict(TRAIN_CONFIG["optimizer"]["params"])
    g = torch.Generator().manual_seed(17)
    n = OFFLOAD_ADAM_N
    p0 = torch.randn(n, generator=g)
    grads = [torch.randn(n, generator=g) * 1e-2 for _ in range(3)]
    adam = DeepSpeedCPUAdam(lr=kw["lr"], weight_decay=kw["weight_decay"])
    got = [p0.clone(), torch.zeros(n), torch.zeros(n)]
    want = [p0.clone(), torch.zeros(n), torch.zeros(n)]
    ms, plain_ms = [], []
    for s, gr in enumerate(grads, 1):
        t = time.perf_counter()
        adam.step(*got[:1], gr, *got[1:])
        ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        adam_step_plain(*want[:1], gr, *want[1:], step=s, lr=kw["lr"],
                        weight_decay=kw["weight_decay"])
        plain_ms.append((time.perf_counter() - t) * 1e3)
    # the loop's OpenMP team follows the calling thread's thread count
    threads = torch.get_num_threads()
    scaling = {}
    scratch = [t.clone() for t in got]
    try:
        for nt in sorted({1, max(1, threads // 2), threads}):
            torch.set_num_threads(nt)
            t = time.perf_counter()
            adam.step(*scratch[:1], grads[0], *scratch[1:], increment=False)
            scaling[nt] = round((time.perf_counter() - t) * 1e3, 2)
    finally:
        torch.set_num_threads(threads)
    err = {}
    for name, a, b in zip(("params", "m", "v"), got, want):
        torch.testing.assert_close(a, b, **OFFLOAD_ADAM_TOL,
                                   msg=f"offload (a): host Adam {name}")
        err[name] = float((a - b).abs().max())
    gbs = 28 * n / (min(ms) / 1e3) / 1e9
    omp = openmp_runtimes()
    env = {k: v for k, v in os.environ.items()
           if k.startswith(("OMP_", "GOMP_", "KMP_"))}
    log(f"offload (a) 1: host Adam vs its plain twin, {n} elements, 3 "
        f"steps: max abs err {err} (rtol {OFFLOAD_ADAM_TOL['rtol']}, atol "
        f"{OFFLOAD_ADAM_TOL['atol']}); a call {[round(m, 2) for m in ms]} "
        f"ms = {gbs:.1f} GB/s of 28 B an element (plain twin "
        f"{[round(m, 2) for m in plain_ms]} ms); ms a call by OpenMP "
        f"threads {scaling}; OpenMP runtimes in the process {omp}, env "
        f"{env}, torch threads {threads}, {os.cpu_count()} CPUs, "
        f"{len(os.sched_getaffinity(0))} in the affinity mask")
    return dict(err=err, ms=ms, plain_ms=plain_ms, gb_s=gbs, openmp=omp,
                threads_ms=scaling)


def offload_full(torch, ctx) -> dict:
    """(a) llama3-1b at full width and depth, the optimizer on the host,
    against phase 5's on-card AdamW; (b) overlap_step and the top-k
    split."""
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.models.spec import num_params
    from deepspeed_tpu_torch.runtime.checkpoint import flatten_tree

    res = {"adam": offload_adam_check(torch, ctx)}
    vocab = offload_model().cfg.vocab_size
    batch = offload_batch(vocab)

    def build(tag, device="cpu", **kw):
        ctx["sync"]()
        t = time.perf_counter()
        eng, *_ = tds.initialize(offload_model(),
                                 offload_config(device, **kw),
                                 device=ctx["device"])
        ctx["sync"]()
        res.setdefault("build_s", {})[tag] = round(time.perf_counter() - t, 2)
        return eng

    card = build("card", device=None)
    n = num_params(card.params)
    ref = offload_steps(ctx, card, batch, OFFLOAD_STEPS)
    card.shutdown()
    del card   # the last reference: its card and host memory go
    free_card(torch, ctx["device"])
    ctx["reset_peak"]()
    eng = build("offload")
    sync = offload_steps(ctx, eng, batch, 1)
    kept = {k: p.detach().to("cpu", copy=True)
            for k, p in flatten_tree(eng.params).items()}
    for k, v in offload_steps(ctx, eng, batch, OFFLOAD_STEPS - 1).items():
        sync[k] += v
    peak = ctx["peak"]() / 1e9
    differ = masters_equal_params(torch, eng)
    rss = host_gb("VmRSS")
    eng.shutdown()
    del eng   # the last reference: its card and host memory go
    free_card(torch, ctx["device"])
    # upload_overlap off: its first step bit-equal to the streamed one's;
    # then it replays (b)'s overlapped trajectory with stale gradients
    plain = build("upload_overlap off", aio={"upload_overlap": False})
    overlap_differ, serial = [], {}

    def first_step():
        overlap_differ.extend(
            k for k, p in flatten_tree(plain.params).items()
            if not torch.equal(p.detach().cpu(), kept[k]))
        rep = plain.offload_report()
        serial.update({k: rep[f"last_{k}_ms"]
                       for k in ("d2h", "adam", "upload")})

    stale = stale_steps(ctx, plain, batch, OFFLOAD_STEPS,
                        after_first=first_step)
    plain.shutdown()
    del plain   # the last reference: its card and host memory go
    free_card(torch, ctx["device"])
    del kept
    split = sync["split"][-1]
    log(f"offload (a) [{ctx['card']}]: {n / 1e9:.3f}B params, on-card "
        f"AdamW losses {ref['losses']} step ms "
        f"{[a + b for a, b in zip(ref['fwd_bwd_ms'], ref['opt_ms'])]}; "
        f"offload losses {sync['losses']}, grad norms {sync['norms']}; "
        f"fwd+bwd ms {sync['fwd_bwd_ms']}, step() ms {sync['opt_ms']}, "
        f"last split d2h {split['d2h']} adam {split['adam']} upload "
        f"{split['upload']} ms (all steps {sync['split']}); upload_overlap "
        f"off (its first step): split {serial}; "
        f"peak card {peak:.2f} GB, host RSS {rss:.2f} GB, builds "
        f"{res['build_s']} s")
    if differ:
        raise AssertionError(f"offload (a): params on the card differ from "
                             f"their host masters: {differ[:5]}")
    if sync["losses"][0] != ref["losses"][0]:
        raise AssertionError(f"offload (a): first loss {sync['losses'][0]} "
                             f"!= on-card AdamW's {ref['losses'][0]}")
    np.testing.assert_allclose(sync["losses"], ref["losses"],
                               rtol=OFFLOAD_LOSS_RTOL,
                               err_msg="offload (a): losses vs on-card AdamW")
    if overlap_differ:
        raise AssertionError(f"offload (a): upload_overlap on and off give "
                             f"other params: {overlap_differ[:5]}")
    if stale[0] != sync["losses"][0]:
        raise AssertionError(f"offload (a): upload_overlap on and off give "
                             f"other losses {sync['losses']} {stale}")
    res.update(params=n, card=ref, sync=sync, no_upload_overlap=serial,
               peak_gb=round(peak, 2), host_rss_gb=round(rss, 2))

    # (b) overlap_step: the host step of step N runs during step N+1's
    # forward and backward
    eng = build("overlap_step", zenflow={"overlap_step": True})
    over = offload_steps(ctx, eng, batch, OFFLOAD_STEPS + 1)
    eng.shutdown()
    del eng   # the last reference: its card and host memory go
    free_card(torch, ctx["device"])
    shift = [abs(a - b) / abs(b) for a, b in
             zip(over["losses"][1:], sync["losses"])]
    log(f"offload (b) overlap_step [{ctx['card']}]: losses "
        f"{over['losses']}; the synchronous run {sync['losses']} (shifted "
        f"one step: rel diff {shift}); replayed with one-step-stale "
        f"gradients {stale}; fwd+bwd ms "
        f"{over['fwd_bwd_ms']} (sync {sync['fwd_bwd_ms']}: the C++ loop's "
        f"OpenMP threads run beside it), step() ms {over['opt_ms']} "
        f"(sync {sync['opt_ms']}), step ms "
        f"{[a + b for a, b in zip(over['fwd_bwd_ms'], over['opt_ms'])]} "
        f"(sync {[a + b for a, b in zip(sync['fwd_bwd_ms'], sync['opt_ms'])]})")
    np.testing.assert_allclose(over["losses"][1], over["losses"][0],
                               rtol=OFFLOAD_FIRST_RTOL,
                               err_msg="offload (b): overlap's first losses")
    # the first shifted step is the synchronous run's exactly; later ones
    # read a stale gradient, which the replay reproduces bit for bit
    np.testing.assert_allclose(over["losses"][1:3], sync["losses"][:2],
                               rtol=OFFLOAD_SHIFT_RTOL,
                               err_msg="offload (b): overlap vs sync shifted")
    if over["losses"][1:] != stale:
        raise AssertionError(f"offload (b): overlap losses {over['losses']} "
                             f"are not the stale-gradient replay's {stale}")
    res["overlap"] = dict(over, stale=stale, shift=shift)

    # (b) the top-k split: unselected columns move only at a boundary
    eng = build("topk", zenflow=dict(OFFLOAD_TOPK))
    leaf = flatten_tree(eng.params)[OFFLOAD_TOPK_LEAF]
    moved = []
    topk = {k: [] for k in ("losses", "fwd_bwd_ms", "opt_ms")}
    for step in range(OFFLOAD_STEPS):
        before = leaf.detach().clone()
        r = offload_steps(ctx, eng, batch, 1)
        for k in topk:
            topk[k] += r[k]
        idx = eng._offload._idx[OFFLOAD_TOPK_LEAF]
        keep = torch.zeros(leaf.shape[-1], dtype=torch.bool,
                           device=leaf.device)
        keep[idx] = True
        delta = (leaf.detach() - before).abs()
        moved.append((float(delta[..., keep].max()),
                      float(delta[..., ~keep].max())))
    k, cols = int(keep.sum()), leaf.shape[-1]
    del leaf, before, delta, idx
    eng.shutdown()
    del eng   # the last reference: its card and host memory go
    free_card(torch, ctx["device"])
    log(f"offload (b) top-k {OFFLOAD_TOPK} [{ctx['card']}]: losses "
        f"{topk['losses']}, step ms "
        f"{[a + b for a, b in zip(topk['fwd_bwd_ms'], topk['opt_ms'])]}; "
        f"{OFFLOAD_TOPK_LEAF}'s {k} selected / {cols - k} other "
        f"columns, max |change| a step {moved}")
    interval = OFFLOAD_TOPK["update_interval"]
    for step, (sel, other) in enumerate(moved):
        boundary = (step + 1) % interval == 0
        if not sel > 0 or (other > 0) != boundary:
            raise AssertionError(f"offload (b): top-k step {step} "
                                 f"(boundary {boundary}) moved selected "
                                 f"{sel}, other {other}")
    res["topk"] = dict(topk, moved=moved, selected=k)
    return res


def offload_nvme(torch, ctx) -> dict:
    """(c) the NVMe tier in the run's temporary directory at
    ``OFFLOAD_NVME_LAYERS`` layers: serial and depth 2 against the CPU
    tier bit for bit; then a checkpoint of the CPU-tier engine after its
    last step, loaded into a fresh engine: the next step bit-equal."""
    import shutil
    import tempfile

    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.models.spec import num_params
    from deepspeed_tpu_torch.runtime.checkpoint import flatten_tree

    tmp = tempfile.mkdtemp(prefix="offload_phase_")
    model = offload_model(num_layers=OFFLOAD_NVME_LAYERS)
    batch = offload_batch(model.cfg.vocab_size)
    res = {"fs": fs_type(tmp)}
    try:
        runs = {}
        for tag, device, aio in (("cpu", "cpu", None),
                                 ("nvme serial", "nvme",
                                  {"prefetch_depth": 0}),
                                 ("nvme depth 2", "nvme",
                                  {"prefetch_depth": 2})):
            path = os.path.join(tmp, tag.replace(" ", "_"))
            t = time.perf_counter()
            eng, *_ = tds.initialize(
                offload_model(num_layers=OFFLOAD_NVME_LAYERS),
                offload_config(device, aio=aio, nvme_path=path),
                device=ctx["device"])
            built = time.perf_counter() - t
            r = offload_steps(ctx, eng, batch, OFFLOAD_NVME_STEPS)
            r["build_s"] = round(built, 2)
            r["state"] = host_tier(eng)
            r["report"] = eng.offload_report()
            runs[tag] = r
            if tag != "cpu":
                eng.shutdown()
                del eng   # the last reference: its card and host memory go
                free_card(torch, ctx["device"])
                continue
            n = num_params(eng.params)
            base = eng
        want = runs["cpu"]["state"]
        same = {tag: [k for k in want if not np.array_equal(
            runs[tag]["state"][k], want[k])] for tag in runs}
        for tag, r in runs.items():
            log(f"offload (c) {tag} [{ctx['card']}]: {n / 1e9:.3f}B params "
                f"({OFFLOAD_NVME_LAYERS} layers), {res['fs']} temp dir: "
                f"losses {r['losses']}, step() ms {r['opt_ms']}, split "
                f"{r['split']}, built in {r['build_s']} s, stall fraction "
                f"{r['report']['pipeline_stall_fraction']}; keys differing "
                f"from the CPU tier {same[tag][:5]}")
        bad = {t: s for t, s in same.items() if s}
        if bad:
            raise AssertionError(f"offload (c): NVMe tiers differ from the "
                                 f"CPU tier after {OFFLOAD_NVME_STEPS} "
                                 f"steps: {bad}")
        # resume: save after the last step, one more step, and the same
        # step from the loaded tag
        ckpt = os.path.join(tmp, "ckpt")
        t = time.perf_counter()
        base.save_checkpoint(ckpt)
        save_s = time.perf_counter() - t
        tag_dir = os.path.join(ckpt, f"global_step{OFFLOAD_NVME_STEPS}")
        host_file = os.path.join(tag_dir, "host_optimizer.npz")
        after = offload_steps(ctx, base, batch, 1)
        want = {k: p.detach().to("cpu", copy=True) for k, p in
                flatten_tree(base.params).items()}
        base.shutdown()
        del base   # the last reference: its card and host memory go
        free_card(torch, ctx["device"])
        fresh, *_ = tds.initialize(
            offload_model(num_layers=OFFLOAD_NVME_LAYERS),
            offload_config("cpu", seed=5), device=ctx["device"])
        t = time.perf_counter()
        fresh.load_checkpoint(ckpt)
        load_s = time.perf_counter() - t
        resumed = offload_steps(ctx, fresh, batch, 1)
        differ = [k for k, p in flatten_tree(fresh.params).items()
                  if not torch.equal(p.detach().cpu(), want[k])]
        fresh.shutdown()
        del fresh   # the last reference: its card and host memory go
        free_card(torch, ctx["device"])
        log(f"offload (c) resume: tag {dir_bytes(tag_dir) / 1e9:.3f} GB "
            f"(host_optimizer.npz {os.path.getsize(host_file) / 1e9:.3f} "
            f"GB), save {save_s:.1f} s, load {load_s:.1f} s; step "
            f"{OFFLOAD_NVME_STEPS + 1} loss uninterrupted {after['losses']} "
            f"resumed {resumed['losses']}; params differing {differ[:5]}")
        if resumed["losses"] != after["losses"] or differ:
            raise AssertionError(f"offload (c): the resumed step differs: "
                                 f"{resumed['losses']} vs {after['losses']},"
                                 f" params {differ[:5]}")
        res.update(runs={t: {k: v for k, v in r.items() if k != "state"}
                         for t, r in runs.items()},
                   params=n, save_s=save_s, load_s=load_s)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def offload_big(torch, ctx) -> dict:
    """(d) ``OFFLOAD_BIG`` at full width, ``OFFLOAD_BIG_LAYERS`` layers,
    the optimizer on the host: three steps, finite losses, the card's peak
    below its memory."""
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.models.spec import num_params

    avail = host_gb("MemAvailable", "/proc/meminfo")
    model = offload_model(OFFLOAD_BIG, num_layers=OFFLOAD_BIG_LAYERS)
    cfg = model.cfg
    ctx["reset_peak"]()
    t = time.perf_counter()
    eng, *_ = tds.initialize(model, offload_config(
        "cpu", train_micro_batch_size_per_gpu=OFFLOAD_BIG_MICRO),
        device=ctx["device"])
    ctx["sync"]()
    built = time.perf_counter() - t
    n = num_params(eng.params)
    batch = offload_batch(cfg.vocab_size, OFFLOAD_BIG_MICRO)
    r = offload_steps(ctx, eng, batch, OFFLOAD_STEPS)
    peak = ctx["peak"]() / 1e9
    rss = host_gb("VmRSS")
    hwm = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
    total = (torch.cuda.get_device_properties(0).total_memory / 1e9
             if ctx["device"] == "cuda" else float("inf"))
    eng.shutdown()
    del eng   # the last reference: its card and host memory go
    free_card(torch, ctx["device"])
    log(f"offload (d) [{ctx['card']}]: {OFFLOAD_BIG} D={cfg.hidden_size} "
        f"L={cfg.num_layers} of {offload_model(OFFLOAD_BIG).cfg.num_layers}"
        f" (a constant; MemAvailable {avail:.2f} GB at the start of (d), "
        f"16 B a param on the host), {n / 1e9:.3f}B params, micro "
        f"{OFFLOAD_BIG_MICRO} x {batch['input_ids'].shape[1]}, built in "
        f"{built:.1f} s: losses {r['losses']}, fwd+bwd ms "
        f"{r['fwd_bwd_ms']}, step() ms {r['opt_ms']}, split {r['split']}; "
        f"peak card {peak:.2f} of {total:.2f} GB, host RSS {rss:.2f} GB "
        f"(peak {hwm:.2f}); on-card AdamW would hold {16 * n / 1e9:.1f} GB "
        f"of params, grads, m and v (offload: {8 * n / 1e9:.1f})")
    if not np.isfinite(r["losses"]).all():
        raise AssertionError(f"offload (d): non-finite losses {r['losses']}")
    if not peak < total:
        raise AssertionError(f"offload (d): peak {peak} GB not below the "
                             f"card's {total} GB")
    return dict(r, params=n, peak_gb=round(peak, 2), rss_gb=round(rss, 2),
                hwm_gb=round(hwm, 2), mem_available_gb=round(avail, 2),
                layers=cfg.num_layers, build_s=round(built, 1))


def offload(torch, KERNELS, reset_counts, device="cuda"):
    """Phase 17: ZeRO-Offload on one card -- (a) llama3-1b with the
    optimizer on the host against on-card AdamW, (b) ZenFlow's
    overlap_step and top-k split, (c) the NVMe tier and a resume, (d)
    llama3-8b cut in depth. Returns the phase's launches per kernel."""
    cuda = torch.device(device).type == "cuda"
    ctx = dict(device=device, sync=(torch.cuda.synchronize if cuda
                                    else lambda: None),
               card=card_line() if cuda else device,
               peak=(torch.cuda.max_memory_allocated if cuda
                     else lambda: 0),
               reset_peak=(torch.cuda.reset_peak_memory_stats if cuda
                           else lambda: None))
    free_card(torch, device)
    empty_host = getattr(torch._C, "_host_emptyCache", None)
    if cuda and empty_host is not None:
        # earlier phases' page-locked tensors (pin_memory=True) stay cached
        # in torch's host allocator: give them back before (d)'s 64 GB
        empty_host()
    log(f"offload: MemAvailable {host_gb('MemAvailable', '/proc/meminfo'):.2f}"
        f" GB, host RSS {host_gb('VmRSS'):.2f} GB at the start")
    t_phase = time.perf_counter()
    reset_counts()
    full = offload_full(torch, ctx)
    nvme = offload_nvme(torch, ctx)
    big = offload_big(torch, ctx)
    counts = {k: KERNELS[k].launches for k in TRAIN_KERNELS}
    missing = [k for k, v in counts.items() if not v] if cuda else []
    if missing:
        raise AssertionError(f"offload: kernels never launched {missing} "
                             f"({counts})")
    log(f"offload: launches {counts}; phase "
        f"{time.perf_counter() - t_phase:.1f} s [{ctx['card']}]")
    PHASE_NOTES["offload"] = dict(full=full, nvme=nvme, big=big)
    return counts


def main() -> int:
    # the train phase follows the 8B serve phase in one process
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.ops import quant_matmul as qm

    card = card_line()
    log(f"device: {card} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda})")

    t = time.perf_counter()
    spent = _build.build_all()
    log(f"build: {time.perf_counter() - t:.1f} s {spent} -> "
        f"{_build.build_dir()}")
    build_reports(_build)

    rows = kernel_checks(torch, pa, fa, _build.KERNELS)
    chunked_equals_whole(torch, pa, fa)
    for sfx, H, K, d in HEAD_DIM_SHAPES:
        rows.update(kernel_checks(torch, pa, fa, _build.KERNELS, H, K, d, sfx,
                                  seed=1234 + d))
    rows.update(qmm_checks(torch, qm, _build.KERNELS))
    rows.update(backward_checks(torch, fa, _build.KERNELS))
    probe_rows, probed, _ = probe_checks(torch, pa, _build.KERNELS,
                                         _build.reset_counts)
    rows.update(probe_rows)
    served, bf16_logits, served_tree = serve(torch, pa, fa, _build.KERNELS,
                                             _build.reset_counts)
    gc.collect()
    torch.cuda.empty_cache()
    trained = train(torch, fa, _build.KERNELS, _build.reset_counts)
    gc.collect()
    torch.cuda.empty_cache()
    quant = serve_quant(torch, pa, qm, _build.KERNELS, _build.reset_counts,
                        bf16_logits)
    gc.collect()
    torch.cuda.empty_cache()
    dense = serve_dense(torch, pa, _build.KERNELS, _build.reset_counts)
    gc.collect()
    torch.cuda.empty_cache()
    head = head_dims(torch, pa, fa, _build.KERNELS, _build.reset_counts)
    gc.collect()
    torch.cuda.empty_cache()
    feat, kept = serve_features(torch, pa, fa, _build.KERNELS,
                                _build.reset_counts, fingerprint=served_tree)
    obs = observability(torch, _build.KERNELS, _build.reset_counts, **kept)
    srv = serving(torch, pa, fa, _build.KERNELS, _build.reset_counts,
                  kept["model"], kept["tree"])
    del kept
    gc.collect()
    torch.cuda.empty_cache()
    flt = fleet(torch, pa, qm, fa, _build.KERNELS, _build.reset_counts)
    gc.collect()
    torch.cuda.empty_cache()
    ckpt = checkpoint(torch, fa, _build.KERNELS, _build.reset_counts)
    gc.collect()
    torch.cuda.empty_cache()
    feats = train_features(torch, fa, _build.KERNELS, _build.reset_counts)
    gc.collect()
    torch.cuda.empty_cache()
    moe = moe_train(torch, fa, _build.KERNELS, _build.reset_counts)
    gc.collect()
    torch.cuda.empty_cache()
    moe_srv = moe_serve(torch, pa, fa, qm, _build.KERNELS,
                        _build.reset_counts)
    gc.collect()
    torch.cuda.empty_cache()
    off = offload(torch, _build.KERNELS, _build.reset_counts)

    def entry(r):
        e = {"max_abs_err": r["err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
             "bound_by": r["bound"][1], "library_ms": r["library_ms"],
             "wrapper_ms": r["wrapper_ms"], "shape": r["shape"]}
        if "library" in r:
            e["library"] = r["library"]
        if "tiles" in r:
            e["worst_tile_rel"] = {t: x[2] for t, x in r["tiles"].items()}
            e["tile_rel_gate"] = BWD_REL
        if "grad_err" in r:
            e["grad_max_abs_err"] = r["grad_err"]
        if "splits" in r:
            e["splits"] = r["splits"]
        if "loop_ms" in r:                   # A-C, G/H at B <= 16, I at
                                             # t=1: a CUDA graph
            e["loop_ms"] = r["loop_ms"]
        if "launches_per_call" in r:         # G/H at B <= 16, I
            e["launches_per_call"] = r["launches_per_call"]
        if "turns" in r:
            e["turns_ms"] = dict(zip(("library", "kernel", "kernel_again",
                                      "library_again"), r["turns"]))
        if "e_plus_f" in r:                  # E then F vs SDPA's backward
            e["e_plus_f"] = r["e_plus_f"]
        return e

    kernels = []
    for name, k in _build.KERNELS.items():
        by_phase = {p: c[name] for p, c in (("kernels", probed),
                                             ("serve", served),
                                             ("train", trained),
                                             ("serve_quant", quant),
                                             ("serve_dense", dense),
                                             ("head_dims", head),
                                             ("serve_features", feat),
                                             ("observability", obs),
                                             ("serving", srv),
                                             ("fleet", flt),
                                             ("checkpoint", ckpt),
                                             ("train_features", feats),
                                             ("moe_train", moe),
                                             ("moe_serve", moe_srv),
                                             ("offload", off))
                    if c.get(name)}
        e = {"name": name, "route": "cuda", "source": k.source,
             "replaces": k.replaces, "launches": sum(by_phase.values()),
             "launches_by_phase": by_phase}
        variants = [k for k in rows if k.startswith(f"{name}/int")]
        if name in rows:                     # A-D, I-K, A/B's int modes
            e.update(entry(rows[name]))
            if f"{name}/train" in rows:
                e["at_train_shape"] = entry(rows[f"{name}/train"])
            more = {r.split("/", 1)[1]: entry(rows[r]) for r in rows
                    if r.startswith(f"{name}/") and r != f"{name}/train"}
            if more:                         # I at t=1, J's other shapes
                e["variants"] = more
        elif variants:                       # G, H: int4 (at B=6) first
            e.update(entry(rows[variants[0]]))
            e["variants"] = {k.split("/", 1)[1]: entry(rows[k])
                             for k in variants[1:]}
        else:                                # E, F: training shape, d=128
            e.update(entry(rows[f"{name}/train"]))   # then d=96 and d=256
            e["library"] = rows[f"{name}/train"]["library"]
            for tag in ("d128", "d96", "d256"):
                e[f"at_{tag}"] = entry(rows[f"{name}/{tag}"])
        kernels.append(e)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
