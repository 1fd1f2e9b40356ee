#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. ``card``      the card (nvidia-smi name and power limit), torch and CUDA.
2. ``build``     builds the hand-written kernels from ``src/repro_torch/
                 kernels/csrc`` with nvcc, one nvcc per source, all started
                 together, and times the build.
3. ``parity``    each kernel against its plain PyTorch version on the card.
                 Wavelets: w4i, w4l, w3ai; n in {8, 16, 32, 64} at B = 64,
                 128 at B = 4, 256 at B = 2 (the cluster kernel to n = 64,
                 the staged one above); every valid level count; blocks
                 uniform in [-50, 50].  Forward within rtol=1e-5, atol=2e-3
                 (tests/test_kernels.py); inverse and round trip within
                 rtol=1e-5, atol=1e-4 * 50 (tests/test_kernels.py), except
                 w4i at 3 or more levels, held to a fixed atol=3e-2: its
                 boundary extrapolation makes coefficients of ~4e3, whose
                 rounding the synthesis amplifies, so over 64 blocks float32
                 itself exceeds 1e-4 * 50 there (the JAX package's own
                 round trip reads 5.6e-3 at 3 levels on the CPU).  A block's
                 output bits independent of the batch size.
                 zfpx: n in {8, 12, 16, 32, 64}, eps in {1e-4, 1e-3, 0}, B = 64
                 blocks uniform in [-50, 50] (the last 32 scaled by powers of
                 two) with the edge cells of tests/test_torch_zfpx.py in
                 blocks 1-5; emax, q and the decoded bits equal, bit for bit.
                 lorenzo: n in {4, 6, 7, 8, 10, 16, 24, 25, 32, 33, 64} at
                 B = 64 and n = 128 at B = 2 (the decode's cluster kernel to
                 n = 64, its staged path above), eps in {1e-4, 1e-3, 2e-7} (2e-7:
                 |q| > 2^24), blocks uniform in [-50, 50], at B = 64 with the
                 traps of tests/test_torch_lorenzo.py in blocks 1-4
                 (amplitude 3e4, NaN and inf, subnormals and zeros, values
                 on the half-grid); residuals and decoded bits equal, bit for
                 bit, the decode also of the first 1, 3 and 32 blocks, and
                 the round trip of the plain blocks within eps * (1 + 1e-4)
                 + spacing(50); residuals over all of int32 (wrapping) at
                 n = 16, 32 and 64, B = 64, and a subnormal 2 eps decode to
                 the same bits.
                 wavelet_pack: at each wavelet side and batch above, the
                 forward's output of blocks uniform in [-50, 50] at eps
                 1e-3 and 20, and of the blocks scaled by 2e-5 at eps
                 1e-3 (the line reports each case's share of values
                 kept): counts, packed mask, coarse corners and details
                 equal the plain version's on the card, bit for bit.
                 Containers written on the card decode on the CPU's plain
                 path and the other way round: wavelet within the scheme's
                 bound of 100 eps, with the chunk bytes of a container
                 written on the CPU; zfpx and lorenzo to the same bits as a
                 container written on the CPU, whose chunk bytes they have.
                 An szx file written by the CLI with --device cuda records
                 "host" (szx has no kernel, as in the reference) and
                 decodes within its bound.
   ``bits``      the wavelet kernels against the plain version on the CPU,
                 bit for bit: each kernel's input copied to the CPU, the
                 plain forward3d/inverse3d run there, the bits compared
                 (the inverse takes the kernel's forward output).  Every
                 kind; n in {8, 16, 32, 64}, every level count, B = 64
                 (n = 64: B = 8, 2M values a case, as at n = 32);
                 n = 128, B = 1, full depth; amplitudes 50, 1e-36 and 1e-39
                 (subnormal intermediates and inputs); and n = 256, B = 1,
                 w3ai at full depth and amplitude 50.  Reports per case the
                 count of differing values and the largest difference; a
                 difference is reported, not failed.  Then the lorenzo
                 decode at n = 32, B = 32 and n = 64, B = 4 against the CPU's
                 plain version, on residuals over all of int32 and from an
                 encode: a differing value fails.
4. ``main_path`` the CLI entry point, ``repro_torch.launch.compress.main``,
                 on one 512^3 cavitation snapshot at t = 9.4 us (the paper's
                 70-bubble cloud), all four QoIs, default spec (w3ai wavelet,
                 eps = 1e-3, 32^3 blocks, byte shuffle, zlib), on the card;
                 each container is read back on the card.  Per QoI: CR, PSNR,
                 max |x - x^|, which must be <= 100 eps, and seconds.  The
                 kernels' launch counts are zeroed just before and read just
                 after: each kernel of the path must have run.  The CLI's
                 report also splits each QoI's write and read into the
                 pipeline's stage seconds (``core.pipeline.STAGE_SECONDS``).
   ``block64_path`` the same CLI run with ``--block-size 64`` (w3ai, 4
                 levels, 2^3 coarse corner) on the QoI p only: the cluster
                 kernels at n = 64 on the main path, within 100 eps, both
                 wavelet kernels launched (counts zeroed just before).
5. ``zfpx_path`` the same CLI run with ``--scheme zfpx`` (eps = 1e-3) on the
                 QoI p only (its four QoIs took 187-238 s, mostly zlib):
                 max |x - x^| <= 16 eps, the header records the kernel path,
                 and both zfpx kernels ran (counts zeroed just before).
6. ``lorenzo_path`` the same CLI run with ``--scheme lorenzo`` (eps = 1e-3),
                 on the QoI p only (its four took 285 s, 95% zlib): max
                 |x - x^| <= eps * (1 + 1e-4) + spacing(max|x|), the header
                 records the kernel path, and both lorenzo kernels ran
                 (counts zeroed just before).
   ``fpzipx``    fpzipx (no kernel: integer torch ops on the card) against
                 the CPU: the lossless round trip on the card bit-exact on
                 the edge values (NaN payload 0x7fc12345, +-0, 1e-40, +-inf,
                 +-FLT_MAX) and on 32 random +-50 blocks of 32^3; the
                 deltas of random bit patterns over all of uint32, and the
                 decode of random int32 deltas (wrapping sums), equal to the
                 CPU's bits; chunk bytes equal to the CPU's at precisions 32
                 and 16.
   ``auto_interop`` ``--scheme auto`` (default target abs = eps) written on
                 the card and on the CPU in this run: a 128^3 sub-volume of
                 the 512^3 p snapshot (32^3 blocks, 2 chunks), and
                 tests/data/golden_auto_input.npy under the fixture's spec
                 (8^3 blocks, 2 KiB buffer: one block per chunk).  The card's
                 and the CPU's files are byte-identical, footer
                 (``chunk_schemes``) included; the fixture's is the committed
                 tests/data/cz2_auto.cz.  The card decodes cz2_auto.cz to
                 cz2_auto.decoded.npy bit for bit.
   ``auto_path`` the CLI with ``--scheme auto --target abs=1e-3`` on the
                 512^3 p (32^3 blocks, 4 MiB chunks): each chunk's trials
                 encode and decode a 4-block sample under every other
                 scheme, the winner encodes the chunk.  Every one of the six
                 kernels must launch (counts zeroed just before); max
                 |x - x^| <= 1e-3 * (1 + 1e-6) + spacing(max|x|), the
                 trials' own slack; the header records "host", as the
                 reference's auto does.  Prints the footer's chunk mix, the
                 stage seconds, and the tuner's series (``cz_tune_*``).
   ``auto_trials`` the tuner's trials of every 8th chunk of the same
                 512^3 p (target abs=1e-3, 32^3 blocks, 4 MiB chunks: 16
                 of its 128 chunks, spread over the field), run on the
                 card and on the CPU.  Every kernel call of the
                 card's trials is recorded and held to its plain version on
                 the same inputs, bit for bit: the trials' shapes (4-block
                 samples) and eps (zfpx 6.25e-5, lorenzo 1e-3, wavelet w3ai
                 at 3 levels).  Each chunk's trials (scheme, eps, nbytes,
                 max_err, psnr, admissible, error) and its ranking equal the
                 CPU's.
   ``region_path`` random access to the 512^3 p containers that main_path,
                 zfpx_path, lorenzo_path and auto_path wrote (kept for it):
                 for each, ``describe(verify=True)`` and ``inspect``;
                 ``read_field(device="cuda")`` through a MemoryStore and a
                 RangeStore with 2 ms per request (the wavelet container
                 also through a FileStore and an HttpStore on a loopback
                 StaticFileServer), each bit-equal to the MemoryStore read;
                 ``FieldReader`` boxes (one
                 block, an unaligned box of 8 chunks, a two-plane slab of 16
                 chunks, a quarter of the field, 32 chunks) on a fresh 2 ms
                 RangeStore each, cold then warm, bit-equal to the same
                 slice, with ``chunks_decoded`` the box's chunks; slab and
                 quarter again at prefetch 4 with the same bits, requests
                 and bytes.  Each
                 read's launches: one decode launch per chunk decoded (none
                 for szx chunks), none on a warm read.  Prints per container
                 and box the cold and warm ms, the reader's fetch and decode
                 sums, and read_field's seconds per store.
   ``dataset_path`` the dataset store (``repro_torch.store.CZDataset``), run
                 after auto_trials on the 512^3 p it left on the card
                 (copied to the host once: ``append`` takes numpy): one
                 append at t = 9.4 us, default spec, ``stats=True``,
                 ``device="cuda"``, into a new FileStore dataset at
                 ``workers=1`` and another at ``workers=4``.  The two members
                 are byte-identical and have the chunk bytes of main_path's
                 p; the manifests' psnr and max_err are equal, max_err <=
                 100 eps.  Each append launches the forward once and the
                 inverse once per chunk (128: the stats decode).  Then
                 ``read_box`` of region_path's unaligned box (8 chunks)
                 through ``CZDataset`` on a RangeStore (2 ms per request)
                 holding the second dataset's keys, cold then warm: bit-equal
                 to ``FieldReader`` on main_path's p, 8 inverse launches
                 cold and none warm, ``ds.stats()`` agreeing.  Then the CLI
                 in-process on the first dataset: ``inspect``, ``--stats``,
                 ``--json``; an orphaned member and a ``.tmp`` planted,
                 ``gc --dry-run`` lists exactly them, ``gc`` deletes them,
                 and a second dry run finds the dataset clean.  Prints each
                 append's seconds with its stage seconds (summed over the
                 pool's threads) and the stats decode's, the wall seconds
                 of its steps from a trace of the append (the member's
                 write, with its stage 1 and encodes; the stats read, with
                 its decodes; the psnr/max_err pass; the manifest's
                 commit), the host's CPU count and affinity, and the box's
                 cold and warm ms.
   ``parallel_path`` the cluster tier (``repro_torch.cluster``), run after
                 dataset_path on the 512^3 p it left on the card, through
                 one ``ParallelCompressor(4, device="cuda")``: four spawned
                 rank processes, each with its own CUDA context on the
                 card.  The pool's first compress (a 128^3 cube from the
                 middle of p, wavelet, one block per chunk: 64 chunks, ranks
                 4) and the same compress warm give the boot.  Under
                 wavelet, zfpx and lorenzo (eps 1e-3) the cube's shared file
                 at ranks 1, 2 and 4 is byte-identical to the serial
                 ``container.write_field(device="cuda")`` and decodes on the
                 card within the scheme's bound.  p itself (default spec,
                 128 chunks) at ranks 2 and 4 is byte-identical to
                 main_path's p container.  From each compress's trace (the
                 ranks' tracks absorbed onto pids 0..3): every rank's
                 ``encode`` span, whose launch counts show exactly one
                 launch of the scheme's encode kernel on the card, and
                 that kernel's span for its timing.  Prints per rank count of p the
                 wall, ``cz_cluster_phase_seconds`` per phase, the parent's
                 span copy to the host and its write of the span files,
                 each rank's span read, encode wall, stage seconds, kernel
                 span and commit, the seconds in which two
                 or more ranks' stage 1 (and kernels) overlap, and while the
                 pool is warm the card's compute processes and their memory
                 (nvidia-smi) beside the ranks' pids, and the card memory
                 the ranks hold (free memory before the pool less while it
                 is warm, less this process's own reserve's growth); then
                 32 MiB of p pickled through the warm pool's pipe (the
                 reference's handoff) against the staging files' rates,
                 and the staging directory's file system.  Then two
                 ``RankWriter(stats=True, device="cuda")`` ranks append the
                 cube as p and the first 128^3 corner as rho to a new
                 FileStore dataset, ``merge_manifests`` folds both, the
                 dataset reads each back within 100 eps on the card with no
                 sidecar left, and ``gc --dry-run`` finds it clean; last the
                 CLI's ``parallel --ranks 4 --n 128 --qoi p
                 --check-identical --device cuda`` in-process (its own pool)
                 exits 0, bit-identical.
   ``serve_path`` the region server (``repro_torch.serve``), run after
                 parallel_path, over dataset_path's FileStore dataset of the
                 512^3 p (kept for it) and a 128^3 dataset of parallel_path's
                 cube each under zfpx and lorenzo (set-up: their encode
                 launches are checked, not counted), every server in this
                 process on ``device="cuda"``.  Tiers: region_path's box b
                 cold (inverse launches = ``cz_serve_chunks_decoded_total``
                 = its 8 chunks), again (a region-cache hit) and a box over
                 the same chunks (chunk-cache hits), both with no launch.
                 Byte identity: box b, a full-depth 32x32x512 column and
                 one box of each small dataset over HTTP (``raw`` with its
                 ``X-CZ-*`` headers, and ``npy``) and through
                 ``FieldRegionServer.query`` equal ``FieldReader.read_box``
                 on the card; each cold chunk one decode launch of its
                 scheme's kernel.  Coalescing (``cache_chunks=1``): 16
                 clients released by a barrier onto box b get identical
                 bodies, 8 chunks decoded and 8 launches, and coalesced
                 fetches + region flights joined + region-cache hits = 15.
                 The HTTP front: a small keep-alive response, a fresh
                 connection's, and 16 connects at once.  The decode lock:
                 32 distinct cold 64^3 boxes (64 distinct chunks of the one
                 member) served to 1, 4 and 16 concurrent clients, a fresh
                 server per level: wall, queries per s, p50 and p99 from
                 ``cz_serve_request_seconds`` and the clients' clocks, the
                 ``cz_reader_decode_seconds`` sum over the wall, launches
                 (= chunks decoded) and the decode kernel's device time over
                 the wall (torch.profiler).  Last the CLI's ``serve ROOT
                 --port 0`` in a subprocess with no ``--device``: its boot
                 until ``/healthz`` answers, box b bit-equal, ``stats URL``
                 exits 0 and lists ``cz_serve_queries_total``, SIGINT ends
                 it with exit 0 after ``shutting down``.
   ``insitu_path`` in-situ compression while a simulation runs (the paper's
                 Fig. 12), run last: the Euler solver
                 (``repro_torch.fields.euler3d``) on a 5x512^3 float32 state
                 (8 bubbles, the per-card subdomain of the other paths) for
                 10 steps on the card, dt from ``cfl_dt``; a
                 ``FieldSnapshotter(every=5, spec=CompressionSpec(),
                 workers=4, device="cuda")`` (``repro_torch.ckpt``) takes p
                 and rho from ``primitives`` at steps 5 and 10 (one forward
                 launch per field: 4); reopened, ``restore()`` resolves step
                 10 with one inverse launch per chunk (2 x 128), each field
                 within 100 eps of the snapshot taken.  At 128^3: a
                 ``Checkpointer(every=5, keep=2, device="cuda")`` under its
                 default fpzipx saves ``{"U", "step"}`` at steps 5 and 10,
                 ``resume`` gives step 10 with U bit-equal to the live
                 state, and five more steps from each are bit-equal; p
                 snapshotted by a card and a CPU ``FieldSnapshotter`` has
                 the same chunk bytes; five steps on the card agree with
                 five on the CPU within rtol = 1e-5 and atol = 1e-5 of the
                 largest |value| (tests/test_torch_euler3d.py's 20-step
                 tolerance).  Prints the seconds per step, peak card memory,
                 each snapshot's seconds per QoI by its trace spans (the
                 host copy, ``dataset.write``, its ``stage1`` and
                 ``encode``, ``dataset.commit``), CR and max error per QoI,
                 the restore's seconds and the in-situ overhead
                 ``io_s / (sim_s + io_s)`` as benchmarks/bench_insitu.py
                 defines it.
   ``llm_path`` the LLM serve path (``repro_torch.models``, ``serve.step``,
                 ``launch.serve``), run after insitu_path: the CLI entry
                 point ``repro_torch.launch.serve.main`` at smollm-135m's
                 full width (30 layers, d 576, 9 query over 3 KV heads of
                 64, vocab 49152, tied head; random weights from seed 0) on
                 the card, B = 4, a 16-token prompt stepped through the
                 decoder, 32 greedy tokens, float32: the tokens' shape, the
                 two lines it prints, finite logits, parameters and cache
                 on the card.  Prints ms per decode step (synchronized; the
                 CLI's run and a warm second generation, which must give
                 the same tokens), tokens/s, the bytes bound per step
                 (every weight and the whole KV cache read once at 3.35
                 TB/s), peak card memory, and one decode step (the serve
                 builder's ``jit_for`` step on a 1x1 mesh) captured in a
                 CUDA graph and replayed (its device time without the
                 host's gaps, within the tolerance below of the eager
                 step; over the warm step's wall: the device's busy share).
                 The CLI run's last four positions are teacher-forced again
                 from copies of its cache, on the card and on the CPU (its
                 weights copied off the card): each step's logits, the
                 cache after and the CLI's own last logits, card against
                 CPU within the tolerance below.  Then ``prefill`` at the
                 reference's defaults (bf16, masked, q_chunk 256, kv_chunk
                 512) at B = 4, S = 4096 (prefill_32k's 32 x 32768 cut to
                 fit), once: seconds, peak memory, finite float32 logits,
                 held against the float32 prefill of the same weights
                 (q_chunk 1024, kv_chunk 4096: fewer launches, the same
                 sums) within 2^-3 of the largest |float32 logit| (below);
                 torch's bf16 reduced-precision GEMM reduction setting is
                 printed beside it.  Then each of the ten
                 ``reduced`` configs, float32 with TF32 off (asserted):
                 ``prefill`` logits and four ``decode_step``s' logits and
                 caches on the card against the CPU from the same weights,
                 within rtol = 1e-4 and atol = 1e-5 of the largest |CPU
                 value| (tests/test_torch_models.py's tolerance against the
                 reference).  None of the six kernels runs on this path:
                 its launch counts must stay 0 (zeroed just before).
   ``train_path`` training on one card (``repro_torch.train``,
                 ``data.tokens``, the flash backward, ``launch.train``), run
                 after llm_path, TF32 off (asserted): the CLI entry point
                 ``repro_torch.launch.train.main`` (its step the mesh
                 builder's ``jit_for`` on a 1x1 mesh) at smollm-135m's full
                 width on the card, the reference driver's B = 8, S = 64,
                 float32, no remat, 12 steps from random weights (seed 0):
                 every loss finite, every state leaf on the card and float32
                 (step int32), its lines.  Prints ms per step (each step
                 synchronized; the median of the steps after the first
                 two), tokens/s, peak card memory and the step's bounds:
                 6 N tokens flops (``models.costs.model_flops``) at 67
                 TFLOP/s, and AdamW's bytes (p, m, v read and written, g
                 read: 7 float32 passes over the parameters) at 3.35 TB/s.
                 The CLI's first step is taken again on the CPU from a host
                 copy of the same state and batch and held to the card's
                 at the tolerances at ``TRAIN_RTOL`` below.  Then
                 smollm-135m at full width trains at train_4k's S = 4096
                 (B cut to 4) with ``ModelSettings()``'s defaults (bf16,
                 remat "full", q 256 / kv 512): one step to warm up and
                 one timed, both synchronized; ms per step, tokens/s over the
                 timed steps, peak memory, and the bounds (the useful
                 flops, ``models.costs.detailed_flops`` without remat and
                 with the causal half of the scores, at 989 TFLOP/s bf16;
                 AdamW's bytes).  Then each of the ten ``reduced`` configs
                 takes one train step (S 32 in q 8 / kv 16 chunks, so the
                 flash backward sums over blocks) on the card and on the
                 CPU from the same state and batch: loss and grad_norm
                 within rtol 1e-5, m and the new params within the
                 tolerances at ``TRAIN_RTOL`` below.  Then
                 the reduced smollm-135m through ``main`` with
                 ``--fail-at-step 6 --ckpt-every 5``: SystemExit(17) and a
                 step-5 checkpoint; the rerun prints ``[resume] from step
                 5`` and runs 7 steps whose losses agree with an
                 uninterrupted card run's within 1e-5 relative (the
                 embedding's backward sums with atomics on the card).  None
                 of the six kernels runs on this path: its launch counts
                 must stay 0 (zeroed just before each run).
   ``mesh_path`` training on a mesh with a "pod" axis and top-k gradient
                 compression with error feedback (``launch.mesh``,
                 ``train.sharding``, ``train.grad_compress``), run after
                 train_path: smollm-135m at full width, random weights
                 (seed 0), the CLI's settings (B 8 x S 64, float32, TF32
                 off), ``batch_at``'s data.  (a) One process, mesh
                 (1, 1, 1) on ("pod", "data", "model"): from one state,
                 3 dense steps (no ``grad_compress``: the normal branch)
                 and 3 ``topk32`` steps (``compress_blocks``, each leaf one
                 piece, no exchange with one pod), each synchronized; ms
                 per step, the top-k's share of a compressed step (CUDA
                 events around each piece's ``_compress_piece``: its
                 selection, what it sends and its residual), and the bytes
                 one pod would send a step: 4 N dense
                 against the payload's 8 sum(nb k) (tiny leaves dense).  At
                 the first compressed step (whose loss is the dense
                 one's), in every leaf compressed: what is sent plus the
                 residual is the grad, bit for bit (up to the sign of zero
                 and the subnormals XLA flushes), and in every block the
                 smallest kept |value| is at least the largest dropped one;
                 ``topk_compress``/``topk_decompress`` of the embedding's
                 corrected grad (28.3M values, 27 blocks) and of the
                 smallest padded leaf's on the card equal the CPU's bit for
                 bit.  (b) Two processes sharing the card, mesh (2, 1, 1)
                 over gloo (``tcp://localhost``), ``topk32``, 2 steps, each
                 pod on its 4 rows: after each step both hold the same
                 params, m and v (int64 sums of their bits, plain and
                 weighted by position) and the same loss; step 1's loss,
                 the mean of the two half-batch means, within 1e-6
                 relative of (a)'s dense step-1 loss.  Prints the
                 processes' boot (spawn to their group) and ms per step.
                 None of the six kernels runs on this path: the launch
                 counts must stay 0.
   ``dryrun_path`` the dry run and its cost count (``launch.dryrun``,
                 ``launch.hlo_analysis``), after mesh_path: (a) one step of
                 the train CLI's (smollm-135m at full width, B 8 x S 64,
                 float32, its settings and optimizer, a 1x1 mesh,
                 ``donate=False``) counted by the op counter on the card,
                 and the same step counted by the dry run on fake cuda
                 tensors: flops, unfused and fused bytes, score bytes,
                 transcendentals and collectives equal, and no byte
                 allocated on the card by the fake run; (b) the dry run's
                 peak (arguments + temp) against
                 ``torch.cuda.max_memory_allocated`` of an uncounted run
                 of the same step (peak stats reset first, less what
                 was live before but the arguments), within 25%; (c) the
                 step's bounds from the counted flops (over 67 TFLOP/s,
                 float32) and bytes (unfused and fused, over 3.35 TB/s)
                 beside train_path's warm ms per step; (d) ``python -m
                 repro_torch.launch.dryrun --arch smollm-135m --shape
                 decode_32k --mesh both`` on the default device, in a
                 subprocess: exit 0, both cells' JSONs applicable and
                 without an error, their per-device flops, bytes,
                 collective bytes and peak printed; (e) rank 0 of
                 qwen3-32b's decode_32k on the 16x16 mesh counted and run
                 on the card (``--run``: a 256-rank world on the ``fake``
                 backend), its peak within 25% of the count's and under
                 the card's memory; (f) rank 0 of qwen3-32b's train_4k
                 ``topk32`` step on the 2x16x16 mesh, its 64 layers cut to
                 ``COMPRESS_LAYERS`` (full width, 8 rows a rank in 4
                 micro-batches), one step on the card in a 512-rank fake
                 world (:func:`compress_rank`): its peak under the card's
                 memory and within 25% of the host count recorded in
                 PERF.md (``COMPRESS_COUNTED_PEAK``), the compress pass's
                 seconds (CUDA events), peak and pod exchanges printed,
                 the exchanges the plan's batches and the loss's and ce's.
                 (d), (e) and (f) run in processes of their own, started
                 before mesh_path.  None of the six kernels runs on this
                 path: the launch counts must stay 0.
   A kernel's launch count on a path is its wrapper's
   ``cz_kernel_calls_total{device="cuda"}`` series from repro_torch.obs,
   which the wrapper adds one to where its launch succeeded and nowhere
   else (exact under threads); each path sets it to 0 just before its run.
   A rank process's launches are the same counts in its own process, read
   by the rank before and after its encode and carried on its ``encode``
   span (``launches``, ``launches_by_side``).
7. ``kernels``   one row per ported kernel, at its path's shapes (forward,
                 zfpx and lorenzo encode B = 4096, inverse, zfpx and lorenzo
                 decode B = 32 blocks of 32^3: one read-path chunk), the
                 wavelet kernels at n = 64 (forward B = 512, one QoI;
                 inverse B = 4, one read chunk), and the lorenzo decode at
                 n = 64 (B = 4, a read chunk) and the wavelet staged kernel
                 at n = 128 (B = 1, 5 levels), and the pack over the
                 forward's output at B = 4096 (nearly every detail kept
                 at +-50; its bytes: each coefficient read, the counts,
                 the mask, the coarse corners and the details written
                 once), its row also carrying its run on the in-situ
                 cells' fields (``euler512``: ``euler512.w3ai``'s p and
                 rho after 10 steps, bit-equal to the plain version on the
                 CPU, with the share of details kept and the bytes that
                 cross the bus): its launches on its path (the
                 n = 64 wavelet rows on block64_path; the lorenzo n = 64 and
                 wavelet n = 128 rows: the launches at that side counted per
                 side over every path's run, 0 while no path runs it),
                 max |kernel - plain| (every kernel is held
                 to its plain version bit for bit), the kernel's own time per
                 call (``ms``: its device time in a torch.profiler trace of
                 back-to-back calls; the staged wavelet kernel's 15 launches
                 summed), the lorenzo decode's design as its library
                 reports it (cluster or staged, planes per CTA, CTAs per
                 block), the wrapper's time per call
                 (``call_ms``: median of CUDA events around one call, the
                 host's launch path included), the plain version's time,
                 and the least time the card could take (bytes over
                 3.35 TB/s; the wavelets' float32 flops over 67 TFLOP/s,
                 NVIDIA's H100 SXM figures; zfpx's and lorenzo's int32 and
                 float32 operations over 16.7 Tops/s, its 64 int32 lanes per
                 SM).  No single PyTorch call computes any of these
                 functions, so there is no library time.  Each row also
                 carries its launches on auto_path (``auto_path_launches``),
                 region_path (``region_path_launches``), dataset_path
                 (``dataset_path_launches``), parallel_path
                 (``parallel_path_launches``: the parent's and the ranks',
                 each rank's read from its own launch sites), serve_path
                 (``serve_path_launches``) and insitu_path
                 (``insitu_path_launches``).

The parity, bits and kernels lines carry their phase's seconds, and the
``total`` line the script's.  The last line is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import contextlib
import io
import json
import multiprocessing
import os
import shutil
import signal
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12    # H100 SXM float32, outside the tensor cores
# H100 SXM int32: 132 SMs x 64 int32 lanes x 1.98 GHz (the float32 figure
# above counts 128 lanes x 2 flops per FMA); zfpx's operations are int32 and
# float32 ones at one per lane and clock, so they are held to this rate
INT32_OPS_PER_S = 132 * 64 * 1.98e9
AMP = 50.0
FWD_TOL = dict(rtol=1e-5, atol=2e-3)
RT_TOL = dict(rtol=1e-5, atol=1e-4 * AMP)
# w4i at 3 or more levels: float32's own round trip exceeds RT_TOL (see above)
RT_TOL_W4I_L3 = dict(rtol=1e-5, atol=3e-2)
# (n, B) of the wavelet parity cases: the cluster kernel to n = 64, the
# staged kernel above
PARITY_SIDES = ((8, 64), (16, 64), (32, 64), (64, 64), (128, 4), (256, 2))
# (n, B) of the lorenzo parity cases: the decode's cluster kernel to n = 64
# (whole blocks per CTA to 16, slabs above; 24: a short last slab; 7, 25
# and 33: odd sides, loaded without bulk copies, 25 and 33 in clusters of 5
# and 11), the staged path at 128
LORENZO_PARITY_SIDES = ((4, 64), (6, 64), (7, 64), (8, 64), (10, 64), (16, 64), (24, 64),
                        (25, 64), (32, 64), (33, 64), (64, 64), (128, 2))
BIT_AMPLITUDES = (AMP, 1e-36, 1e-39)
# blocks per bits case at n = 64: at 64 blocks its 36 cases held 600M of the
# phase's 700M values (68-104 s in all); 8 blocks give 2M a case, as n = 32
BITS_BLOCKS = {64: 8}
EPS = 1e-3
ZFPX_BOUND = 16 * EPS       # the zfpx scheme's declared bound
N_MAIN, T_MAIN = 512, 9.4
KERNEL_SOURCES = ("wavelet3d", "wavelet_pack", "zfp_transform", "lorenzo")
ZFPX_PATH_QOIS = ("p",)     # one QoI: its four took 187-238 s, mostly zlib
LORENZO_PATH_QOIS = ("p",)  # one QoI: its four took 285 s, 95% zlib
AUTO_TARGET = 1e-3          # auto_path's target, abs=1e-3
AUTO_TRIALS_STRIDE = 8      # auto_trials checks every 8th chunk of the 128
# each kernel row's label in cz_kernel_calls_total
KERNEL_LABELS = {"wavelet3d_forward": "wavelet_forward", "wavelet3d_inverse": "wavelet_inverse",
                 "wavelet_pack": "wavelet_pack",
                 "zfpx_encode": "zfpx_encode", "zfpx_decode": "zfpx_decode",
                 "lorenzo_encode": "lorenzo_encode", "lorenzo_decode": "lorenzo_decode"}
# the wavelet scheme's stage 1 launches the pack once after each forward
# transform, and no other code launches either


def auto_bound(max_abs: float) -> float:
    """What the tuner's trials allow a target abs=1e-3: the target plus one
    float32 ulp at max |x| (repro_torch/tune/trial.py)."""
    import numpy as np

    return AUTO_TARGET * (1 + 1e-6) + float(np.spacing(np.float32(max_abs)))


def lorenzo_bound(max_abs: float, eps: float = EPS) -> float:
    """The lorenzo and szx bound as the reference's tests hold it
    (tests/test_kernels.py): eps, plus float32's spacing of max |x|, since
    past |q| = 2^24 the grid is coarser than 2 eps."""
    import numpy as np

    return eps * (1 + 1e-4) + float(np.spacing(np.float32(max_abs)))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median over ``reps`` launches of one call's time on the card, from
    CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_ms(fn, kernel: str, reps: int, per_call: int = 1) -> float:
    """The kernel's own device time per call, in ms, from a torch.profiler
    trace of ``reps`` back-to-back calls of ``fn``: every CUDA kernel whose
    name holds ``kernel`` counts, ``per_call`` of them in each call (a
    staged path's launches).  The trace can miss a launch at its
    start, so the mean is over those seen; a trace that saw fewer than half
    the launches is taken again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, count = 0.0, 0
        for ev in prof.key_averages():
            if kernel in ev.key:
                us += ev.device_time_total
                count += ev.count
        if reps // 2 <= count / per_call <= reps and us > 0:
            break
    check(reps // 2 <= count / per_call <= reps and us > 0,
          f"profiler saw {count} launches of {kernel} ({us} us) of {reps} x {per_call}")
    return us / 1e3 / (count / per_call)


def wavelet_flops(kind: str, n: int, levels: int, nblocks: int) -> int:
    """Float32 operations of the transform (either direction): per output
    pair of each 1D step, the stencil's multiplies and adds plus the
    split/merge (8) and, for w4l, the update (3); 3 axes per level."""
    per_pair = 11 if kind == "w4l" else 8
    return nblocks * sum(3 * (n >> lv) ** 3 // 2 * per_pair for lv in range(levels))


def bound_ms(nbytes: int, ops: float, ops_per_s: float) -> tuple[float, str]:
    """The least time for moving ``nbytes`` once through HBM and doing
    ``ops`` at ``ops_per_s``: the larger of the two, and which it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def wavelet_bound_ms(kind: str, n: int, levels: int, nblocks: int) -> tuple[float, str]:
    nbytes = 2 * nblocks * n ** 3 * 4  # each block read once and written once
    return bound_ms(nbytes, wavelet_flops(kind, n, levels, nblocks), FP32_FLOPS_PER_S)


def pack_bound_ms(n: int, levels: int, nblocks: int, ndetails: int) -> tuple[float, str]:
    """The pack's bytes: each coefficient read once; the counts, the mask
    at a bit a cell, the coarse corners and the details written once."""
    c = n >> levels
    nbytes = nblocks * (4 * n ** 3 + n ** 3 // 8 + 4 * c ** 3 + 4) + 4 * ndetails
    return bound_ms(nbytes, 0, FP32_FLOPS_PER_S)


# the in-situ benchmark's configuration, whose fields the pack row also runs
EULER512_CONFIG = os.path.join("perfbench", "configs", "euler512.w3ai.json")
EULER512_STEPS, EULER512_SEED = 10, 1


def pack_euler512(torch, ops) -> dict:
    """The pack kernel on the fields the in-situ cells snapshot: the
    ``euler512.w3ai`` state (``perfbench``'s producer and configuration,
    seed ``EULER512_SEED``) after ``EULER512_STEPS`` steps, p and rho,
    blocked and transformed as stage 1 does.  Each QoI's four outputs must
    equal the plain version's on the CPU bit for bit; prints the share of
    details kept, the bytes that cross the bus against the dense stage 1's
    5 B a cell, and the kernel's time beside its bound."""
    from perfbench.producers import euler3d as pb
    from repro_torch.core import blocks as blk
    from repro_torch.kernels.wavelet_pack import pack_plain

    with open(os.path.join(ROOT, EULER512_CONFIG)) as f:
        cfg = json.load(f)
    n, lv = cfg["spec"]["block_size"], 3
    U = pb.init_bubble_cloud(cfg["n"], cfg["cloud"], EULER512_SEED, "cuda",
                             p_ambient=cfg["p_ambient"], p_bubble=cfg["p_bubble"],
                             rho_liquid=cfg["rho_liquid"], rho_gas=cfg["rho_gas"])
    dt = pb.cfl_dt(U, cfg["cfl"])
    for _ in range(EULER512_STEPS):
        U = pb.step(U, dt)
    fields = pb.qoi_fields(U, ("p", "rho"))
    del U
    out = {}
    for q, field in fields.items():
        y = ops.wavelet_forward(blk.blockify(field, n).contiguous(), "w3ai", lv)
        got = ops.wavelet_pack(y, EPS, lv)
        check(_bit_equal(torch, tuple(t.cpu() for t in got), pack_plain(y.cpu(), EPS, lv)),
              f"wavelet_pack on euler512.w3ai {q}: not bit-equal to the plain version")
        nblocks, nd = y.shape[0], got[3].numel()
        b_ms, b_by = pack_bound_ms(n, lv, nblocks, nd)
        out[q] = {"blocks": nblocks, "details": nd,
                  "significant_share": nd / (nblocks * (n ** 3 - (n >> lv) ** 3)),
                  "packed_bytes": sum(t.numel() * t.element_size() for t in got),
                  "dense_bytes": 5 * y.numel(),
                  "ms": kernel_ms(lambda: ops.wavelet_pack(y, EPS, lv), "wavelet_pack_", 20, 3),
                  "call_ms": median_ms(lambda: ops.wavelet_pack(y, EPS, lv), 20),
                  "bound_ms": b_ms, "bound_by": b_by, "bit_equal": True}
    return out


# zfpx operations per 4^3 cell: the lifting (16 per 4-vector, 16 vectors per
# axis, 3 axes) and, per value, encode's flush (2), |x| and max (2), scale
# (1), conversion (1) and truncation (2), or decode's conversion (1), scale
# (1) and flush (2)
ZFPX_LIFT_OPS = 3 * 16 * 16


def zfpx_bound_ms(n: int, nblocks: int, decode: bool) -> tuple[float, str]:
    nc = (n // 4) ** 3
    # the float32 blocks one way, the int32 q and emax streams the other
    nbytes = nblocks * (n ** 3 * 4 + nc * 64 * 4 + nc * 4)
    ops = nblocks * nc * (ZFPX_LIFT_OPS + 64 * (4 if decode else 8))
    return bound_ms(nbytes, ops, INT32_OPS_PER_S)


# lorenzo operations per element: the quantizer (2 multiplies, 2 roundings,
# the FMA, the add, the conversion and 4 flushes of 2 each) and the three
# differences (encode); the three sums, the conversion, the product and its
# flush (decode)
LORENZO_ENC_OPS, LORENZO_DEC_OPS = 18, 7


def lorenzo_bound_ms(n: int, nblocks: int, decode: bool) -> tuple[float, str]:
    nbytes = 2 * nblocks * n ** 3 * 4  # 4 bytes in and 4 out per element
    ops = nblocks * n ** 3 * (LORENZO_DEC_OPS if decode else LORENZO_ENC_OPS)
    return bound_ms(nbytes, ops, INT32_OPS_PER_S)


def phase_parity(torch, wv, ops) -> dict:
    from repro_torch.kernels.wavelet_pack import pack_plain

    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    worst = {"forward_vs_plain": 0.0, "inverse_vs_plain": 0.0, "round_trip": 0.0,
             "plain_round_trip": 0.0}
    per_case = {}
    for kind in wv.WAVELETS:
        for n, nb in PARITY_SIDES:
            for lv in range(1, wv.max_levels(n) + 1):
                x = torch.rand((nb, n, n, n), generator=g, device="cuda") * (2 * AMP) - AMP
                y = ops.wavelet_forward(x, kind, lv)
                y_plain = wv.forward3d(x, kind, lv)
                back = ops.wavelet_inverse(y, kind, lv)
                back_plain = wv.inverse3d(y, kind, lv)
                torch.cuda.synchronize()
                tag = f"{kind} n={n} levels={lv}"
                plain_rt = (wv.inverse3d(y_plain, kind, lv) - x).abs().max().item()
                rt_tol = RT_TOL_W4I_L3 if kind == "w4i" and lv >= 3 else RT_TOL
                errs = {"forward_vs_plain": (y - y_plain).abs().max().item(),
                        "inverse_vs_plain": (back - back_plain).abs().max().item(),
                        "round_trip": (back - x).abs().max().item(),
                        "plain_round_trip": plain_rt}
                check(torch.allclose(y, y_plain, **FWD_TOL), f"forward vs plain: {tag} {errs}")
                check(torch.allclose(back, back_plain, **rt_tol),
                      f"inverse vs plain: {tag} {errs}")
                check(torch.allclose(back, x, **rt_tol), f"round trip: {tag} {errs}")
                check(torch.equal(ops.wavelet_forward(x[:2].contiguous(), kind, lv), y[:2]),
                      f"forward batch invariance: {tag}")
                check(torch.equal(ops.wavelet_inverse(y[:2].contiguous(), kind, lv), back[:2]),
                      f"inverse batch invariance: {tag}")
                for k, e in errs.items():
                    worst[k] = max(worst[k], e)
                per_case[tag] = [errs[k] for k in worst]
    pack = {}
    for n, nb in PARITY_SIDES:
        lv = wv.max_levels(n)
        x = torch.rand((nb, n, n, n), generator=g, device="cuda") * (2 * AMP) - AMP
        for scale, eps in ((1.0, EPS), (1.0, 20.0), (2e-5, EPS)):
            y = ops.wavelet_forward(x * scale, "w3ai", lv)
            got = ops.wavelet_pack(y, eps, lv)
            check(_bit_equal(torch, got, pack_plain(y, eps, lv)),
                  f"wavelet_pack vs plain: n={n} B={nb} scale={scale} eps={eps}")
            pack[f"n={n} scale={scale:g} eps={eps:g}"] = got[3].numel() / y.numel()
    return {"cases": len(per_case), "sides_blocks": PARITY_SIDES, "max_abs_err": worst,
            "batch_invariant": True, "per_case_err": {"columns": list(worst), **per_case},
            "pack_kept_share": pack}


def phase_bits(torch, wv, sz, ops) -> dict:
    """The wavelet kernels against the plain version on the CPU, bit for
    bit: differences are counted and reported, not failed.  Then the
    lorenzo decode at its read chunks (n = 32, B = 32; n = 64, B = 4), on
    residuals over all of int32 and from an encode: integer-exact, so a
    difference fails."""
    g = torch.Generator(device="cuda")
    g.manual_seed(90)
    cases = [(amp, kind, n, lv, BITS_BLOCKS.get(n, 64)) for amp in BIT_AMPLITUDES
             for kind in wv.WAVELETS for n in (8, 16, 32, 64)
             for lv in range(1, wv.max_levels(n) + 1)]
    cases += [(amp, kind, 128, 5, 1) for amp in BIT_AMPLITUDES for kind in wv.WAVELETS]
    cases.append((AMP, "w3ai", 256, 6, 1))
    per_case, differing, worst = {}, 0, 0.0
    for amp, kind, n, lv, nb in cases:
        x = (torch.rand((nb, n, n, n), generator=g, device="cuda") * 2 - 1) * amp
        y = ops.wavelet_forward(x, kind, lv)
        z = ops.wavelet_inverse(y, kind, lv)
        x_cpu, y_cpu, z_cpu = x.cpu(), y.cpu(), z.cpu()
        row = []
        for got, want in ((y_cpu, wv.forward3d(x_cpu, kind, lv)),
                          (z_cpu, wv.inverse3d(y_cpu, kind, lv))):
            diff = got.view(torch.int32) != want.view(torch.int32)
            row += [int(diff.sum()), _max_abs_diff(got, want) if diff.any() else 0.0]
        check(all(torch.isfinite(t).all() for t in (y_cpu, z_cpu)), f"bits: non-finite output {n}")
        per_case[f"{kind} n={n} L={lv} B={nb} amp={amp:g}"] = row
        differing += row[0] + row[2]
        worst = max(worst, row[1], row[3])
    lorenzo = {}
    for n, nb in ((32, 32), (64, 4)):
        x = torch.rand((nb, n, n, n), generator=g, device="cuda") * (2 * AMP) - AMP
        full = torch.randint(-2 ** 31, 2 ** 31, (nb, n, n, n), generator=g, device="cuda",
                             dtype=torch.int64).to(torch.int32)
        for source, r in (("int32", full), ("encode", ops.lorenzo_encode(x, EPS))):
            got, want = ops.lorenzo_decode(r, EPS).cpu(), sz.decode(r.cpu(), EPS)
            differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            lorenzo[f"lorenzo_decode n={n} B={nb} {source}"] = differ
            check(differ == 0, f"bits: lorenzo decode n={n} {source}: {differ} values differ")
    return {"cases": len(per_case), "bit_equal_cases": sum(r[0] + r[2] == 0 for r in
                                                           per_case.values()),
            "differing_values": differing, "max_abs_diff": worst,
            "per_case": {"columns": ["fwd_differing", "fwd_max_abs_diff", "inv_differing",
                                     "inv_max_abs_diff"], **per_case},
            "lorenzo_differing_values": lorenzo}


def zfpx_batch(torch, g, n: int):
    """B = 64 blocks of side n uniform in [-50, 50], the last 32 scaled by
    2^-16 .. 2^15, with the edge cells of tests/test_torch_zfpx.py as cell 0
    of blocks 1-5: a subnormal max (emax -127), emax -101 (an infinite
    scale, with zeros and subnormals), subnormals in a cell of emax -98,
    emax 128, and zeros."""
    x = torch.rand((64, n, n, n), generator=g, device="cuda") * (2 * AMP) - AMP
    x[32:] *= torch.exp2(torch.arange(-16.0, 16.0, device="cuda")).view(32, 1, 1, 1)
    u = torch.rand((4, 4, 4), generator=g, device="cuda") * 2 - 1
    tiny = torch.where(u.abs() < 0.15, u * 0, u.sign() * 1e-39)
    small = torch.where(u.abs() < 0.5, u.sign() * 1.1e-38, u * 2.0 ** -98)
    for b, cell in enumerate((u * 1e-39, torch.where(u.abs() < 0.3, tiny, u * 2.0 ** -101),
                              small, u * (2.0 ** 127 * 1.9), u * 0), start=1):
        x[b, :4, :4, :4] = cell
    return x


ZFPX_EDGE_EMAX = [-127, -101, -98, 128, -127]


def phase_zfpx_parity(torch, zf, ops) -> dict:
    """The zfpx kernels against their plain version on the card, bit for bit."""
    g = torch.Generator(device="cuda")
    g.manual_seed(56)
    cases, worst = 0, 0.0
    for n in (8, 12, 16, 32, 64):
        for eps in (1e-4, 1e-3, 0.0):  # eps = 0 truncates no planes
            tag = f"zfpx n={n} eps={eps}"
            x = zfpx_batch(torch, g, n)
            e, q = ops.zfpx_encode(x, eps)
            e_plain, q_plain = zf.encode(x, eps)
            d = ops.zfpx_decode(e, q, eps, n)
            d_plain = zf.decode(e_plain, q_plain, eps, n)
            torch.cuda.synchronize()
            check(e[1:6, 0].tolist() == ZFPX_EDGE_EMAX, f"{tag}: edge cells {e[1:6, 0].tolist()}")
            check(_bit_equal(torch, e, e_plain), f"{tag}: emax differs from the plain version")
            check(_bit_equal(torch, q, q_plain), f"{tag}: q differs from the plain version")
            check(_bit_equal(torch, d, d_plain),
                  f"{tag}: decoded bits differ from the plain version")
            if eps > 0:  # the bound is 16 eps; unscaled blocks, no edge cell
                err = (d[6:32] - x[6:32]).abs().max().item()
                check(err <= 16 * eps, f"{tag}: round trip {err} > 16 eps")
                worst = max(worst, err)
            cases += 1
    return {"cases": cases, "blocks_per_case": 64, "bit_exact": True,
            "edge_emax": ZFPX_EDGE_EMAX, "round_trip_max_abs_err": worst}


def lorenzo_batch(torch, g, n: int, eps: float, nb: int = 64):
    """``nb`` blocks of side n uniform in [-50, 50]; when nb = 64, with the
    traps of tests/test_torch_lorenzo.py: block 1 at amplitude 3e4 (the
    FMA), block 2 with NaN and +-inf, block 3 subnormal with zeros, block 4
    on the half-grid of 2 eps."""
    x = torch.rand((nb, n, n, n), generator=g, device="cuda") * (2 * AMP) - AMP
    if nb < 64:
        return x
    x[1] *= 600.0
    flat = x[2].view(-1)
    flat[::7] = float("nan")
    flat[1::11] = float("inf")
    flat[2::13] = -float("inf")
    u = torch.rand((n, n, n), generator=g, device="cuda") * 2 - 1
    x[3] = torch.where(u.abs() < 0.2, u * 0, u * 1.1e-38)
    k = torch.randint(-1000, 1000, (n, n, n), generator=g, device="cuda")
    x[4] = (k.float() + 0.5) * 2 * eps
    return x


def phase_lorenzo_parity(torch, sz, ops) -> dict:
    """The lorenzo kernels against their plain version on the card, bit for
    bit; the round trip of the plain blocks within the reference's bound.
    The decode also at B = 1, 3 and 32 (a CTA holding fewer blocks than its
    share, a cluster per block)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(78)
    cases, worst = 0, {}
    for n, nb in LORENZO_PARITY_SIDES:
        for eps in (1e-4, 1e-3, 2e-7):
            tag = f"lorenzo n={n} B={nb} eps={eps}"
            x = lorenzo_batch(torch, g, n, eps, nb)
            r, r_plain = ops.lorenzo_encode(x, eps), sz.encode(x, eps)
            d, d_plain = ops.lorenzo_decode(r, eps), sz.decode(r_plain, eps)
            torch.cuda.synchronize()
            check(_bit_equal(torch, r, r_plain), f"{tag}: residuals differ from the plain one")
            check(_bit_equal(torch, d, d_plain), f"{tag}: decoded bits differ from the plain one")
            for b in (1, 3, 32):
                if b < nb:
                    check(_bit_equal(torch, ops.lorenzo_decode(r[:b], eps), d_plain[:b]),
                          f"{tag}: decode of the first {b} blocks differs from the plain one")
            plain = slice(5, None) if nb == 64 else slice(None)  # the blocks without traps
            err = (d[plain] - x[plain]).abs().max().item()
            bound = lorenzo_bound(AMP, eps)
            check(err <= bound, f"{tag}: round trip {err} > {bound}")
            worst[str(eps)] = max(worst.get(str(eps), 0.0), err)
            cases += 1
    # wrapping sums over all of int32 where slabs carry into each other, and
    # a subnormal 2 eps (decodes to zeros)
    for n in (16, 32, 64):
        for eps in (1e-3, 5e-39):
            r = torch.randint(-2 ** 31, 2 ** 31, (64, n, n, n), generator=g, device="cuda",
                              dtype=torch.int64).to(torch.int32)
            d = ops.lorenzo_decode(r, eps)
            check(_bit_equal(torch, d, sz.decode(r, eps)),
                  f"lorenzo decode n={n} eps={eps}: int32 range")
            cases += 1
    return {"cases": cases, "sides_blocks": LORENZO_PARITY_SIDES, "bit_exact": True,
            "round_trip_max_abs_err_by_eps": worst}


def _recorded_device(container, path: str) -> str:
    with open(path, "rb") as fh:
        return container._read_header(fh)[0]["spec"]["device"]


def phase_interop(tmp: str) -> dict:
    """A small snapshot written on the card decodes on the CPU's plain path
    and the other way round: wavelet within the scheme's bound, zfpx to the
    same bits as a container written on the CPU."""
    import numpy as np

    from repro_torch.core import container
    from repro_torch.core.pipeline import CompressionSpec
    from repro_torch.fields import CloudConfig, cavitation_fields

    f = cavitation_fields(CloudConfig(n=64), T_MAIN, device="cpu")["p"].numpy()
    spec = CompressionSpec()
    errs, paths = {}, {}
    for wdev, rdev in (("cuda", "cpu"), ("cpu", "cuda")):
        path = paths[wdev] = os.path.join(tmp, f"interop_{wdev}.cz")
        container.write_field(path, f, spec, device=wdev)
        check(_recorded_device(container, path) == ("jax" if wdev == "cuda" else "host"),
              f"device provenance {wdev}")
        dec = container.read_field(path, device=rdev)
        errs[f"{wdev}->{rdev}"] = float(np.max(np.abs(dec - f)))
        check(dec.shape == f.shape and np.isfinite(dec).all(), f"interop {wdev}->{rdev}")
        check(errs[f"{wdev}->{rdev}"] <= 100 * EPS, f"interop error {wdev}->{rdev}")
    check(list(container.iter_compressed(paths["cuda"]))
          == list(container.iter_compressed(paths["cpu"])),
          "wavelet chunks written on the card differ from the CPU's")

    zspec = CompressionSpec(scheme="zfpx")
    for wdev in ("cuda", "cpu"):
        paths[wdev] = os.path.join(tmp, f"interop_zfpx_{wdev}.cz")
        container.write_field(paths[wdev], f, zspec, device=wdev)
        check(_recorded_device(container, paths[wdev]) == ("jax" if wdev == "cuda" else "host"),
              f"zfpx device provenance {wdev}")
    check(list(container.iter_compressed(paths["cuda"]))
          == list(container.iter_compressed(paths["cpu"])),
          "zfpx chunks written on the card differ from the CPU's")
    want = container.read_field(paths["cpu"], device="cpu")
    for wdev in ("cuda", "cpu"):
        for rdev in ("cpu", "cuda"):
            dec = container.read_field(paths[wdev], device=rdev)
            check(np.array_equal(dec.view(np.int32), want.view(np.int32)),
                  f"zfpx decode {wdev}->{rdev} differs from cpu->cpu")
    zerr = float(np.max(np.abs(want - f)))
    check(zerr <= ZFPX_BOUND, f"zfpx interop error {zerr}")

    lspec = CompressionSpec(scheme="lorenzo")
    for wdev in ("cuda", "cpu"):
        paths[wdev] = os.path.join(tmp, f"interop_lorenzo_{wdev}.cz")
        container.write_field(paths[wdev], f, lspec, device=wdev)
        check(_recorded_device(container, paths[wdev]) == ("jax" if wdev == "cuda" else "host"),
              f"lorenzo device provenance {wdev}")
    check(list(container.iter_compressed(paths["cuda"]))
          == list(container.iter_compressed(paths["cpu"])),
          "lorenzo chunks written on the card differ from the CPU's")
    want = container.read_field(paths["cpu"], device="cpu")
    for wdev in ("cuda", "cpu"):
        for rdev in ("cpu", "cuda"):
            dec = container.read_field(paths[wdev], device=rdev)
            check(np.array_equal(dec.view(np.int32), want.view(np.int32)),
                  f"lorenzo decode {wdev}->{rdev} differs from cpu->cpu")
    lerr = float(np.max(np.abs(want - f)))
    check(lerr <= lorenzo_bound(float(np.max(np.abs(f)))), f"lorenzo interop error {lerr}")

    # szx has no kernel: on the card its plain math runs as torch ops, and
    # the header says "host", as the reference's does
    from repro_torch.launch import compress

    out = os.path.join(tmp, "interop_szx")
    report = compress.main(["--source", "cavitation", "--n", "64", "--t", str(T_MAIN),
                            "--qoi", "p", "--device", "cuda", "--scheme", "szx",
                            "--out", out])
    check(_recorded_device(container, os.path.join(out, "p.cz")) == "host",
          "szx written on the card does not record host")
    serr = report["fields"]["p"]["max_abs_err"]
    check(serr <= lorenzo_bound(report["fields"]["p"]["max_abs"]), f"szx interop error {serr}")
    return {"wavelet_max_abs_err": errs, "wavelet_chunks_identical": True,
            "zfpx_chunks_identical": True,
            "zfpx_decodes_identical": True, "zfpx_max_abs_err": zerr,
            "lorenzo_chunks_identical": True, "lorenzo_decodes_identical": True,
            "lorenzo_max_abs_err": lerr, "szx_recorded_device": "host",
            "szx_max_abs_err": serr}


FLT_MAX_BITS = 0x7F7FFFFF
# the lossless round trip's edge values, as float32 bit patterns: a NaN
# payload, +0, -0, 1e-40 (subnormal), +-inf, +-FLT_MAX
FPZIPX_EDGES = (0x7FC12345, 0x00000000, 0x80000000, 0x000116C2, 0x7F800000, 0xFF800000,
                FLT_MAX_BITS, 0x80000000 | FLT_MAX_BITS)


def phase_fpzipx(tmp: str) -> dict:
    """fpzipx on the card against the CPU: lossless round trip bit-exact on
    the edge values and on random +-50 blocks; deltas over all of uint32 and
    the decode's wrapping int32 sums equal to the CPU's; chunk bytes equal
    to the CPU's at precisions 32 and 16."""
    import numpy as np
    import torch

    from repro_torch.core import container
    from repro_torch.core import fpzipx as fpz
    from repro_torch.core.pipeline import CompressionSpec

    g = torch.Generator(device="cuda")
    g.manual_seed(23)
    x = torch.rand((32, 32, 32, 32), generator=g, device="cuda") * (2 * AMP) - AMP
    edges = torch.tensor(np.array(FPZIPX_EDGES, np.uint32).view(np.int32), device="cuda")
    x.view(torch.int32).view(-1)[: 64 * edges.numel()] = edges.repeat(64)
    back = fpz.decode(fpz.encode(x))
    check(torch.equal(back.view(torch.int32), x.view(torch.int32)),
          "fpzipx: the lossless round trip on the card is not bit-exact")
    bits = torch.randint(-2 ** 31, 2 ** 31, (8, 32, 32, 32), generator=g, device="cuda",
                         dtype=torch.int64).to(torch.int32)
    cases = 0
    for p in (32, 16, 8):
        d = fpz.encode(bits.view(torch.float32), precision=p)
        check(torch.equal(d.cpu(), fpz.encode(bits.cpu().view(torch.float32), precision=p)),
              f"fpzipx deltas at precision {p} differ from the CPU's")
        cases += 1
    check(torch.equal(fpz.decode(bits).cpu().view(torch.int32),
                      fpz.decode(bits.cpu()).view(torch.int32)),
          "fpzipx decode (wrapping int32 sums) differs from the CPU's")
    f = x.cpu().numpy()  # the 32 blocks, edges included, 4 chunks of 8
    nbytes = {}
    for p in (32, 16):
        spec = CompressionSpec(scheme="fpzipx", precision=p, buffer_bytes=1 << 20)
        paths = {}
        for dev in ("cuda", "cpu"):
            paths[dev] = os.path.join(tmp, f"fpzipx_{p}_{dev}.cz")
            container.write_field(paths[dev], f, spec, device=dev)
        check(list(container.iter_compressed(paths["cuda"]))
              == list(container.iter_compressed(paths["cpu"])),
              f"fpzipx chunks at precision {p} written on the card differ from the CPU's")
        dec = container.read_field(paths["cpu"], device="cuda")
        if p == 32:
            check(np.array_equal(dec.view(np.int32), f.view(np.int32)),
                  "fpzipx container round trip on the card is not bit-exact")
        nbytes[p] = os.path.getsize(paths["cuda"])
    return {"edges": [f"0x{b:08x}" for b in FPZIPX_EDGES], "round_trip_bit_exact": True,
            "delta_cases": cases, "decode_wraps_as_cpu": True,
            "chunks_identical_precisions": [32, 16], "container_bytes": nbytes}


def phase_auto_interop(tmp: str, p512) -> dict:
    """``auto`` written on the card and on the CPU: byte-identical files, the
    footer's chunk_schemes included, for a 128^3 sub-volume of the 512^3 p
    and for the golden fixture's input under its spec (which must give the
    committed cz2_auto.cz); the card decodes cz2_auto.cz bit for bit."""
    import numpy as np

    from repro_torch.core import container
    from repro_torch.core.pipeline import CompressionSpec

    data = os.path.join(ROOT, "tests", "data")
    sub = p512[192:320, 192:320, 192:320].contiguous().cpu().numpy()
    cases = {"p_128": (sub, CompressionSpec(scheme="auto")),
             "golden_auto_input": (np.load(os.path.join(data, "golden_auto_input.npy")),
                                   CompressionSpec(scheme="auto", eps=1e-3, block_size=8,
                                                   buffer_bytes=1 << 11))}
    out = {}
    for name, (f, spec) in cases.items():
        files = {}
        for dev in ("cuda", "cpu"):
            path = os.path.join(tmp, f"auto_{name}_{dev}.cz")
            container.write_field(path, f, spec, device=dev)
            with open(path, "rb") as fh:
                files[dev] = fh.read()
        check(files["cuda"] == files["cpu"],
              f"auto {name}: the file written on the card differs from the CPU's")
        with open(path, "rb") as fh:
            header = container._read_header(fh)[0]
        dec = container.read_field(path, device="cuda")
        err = float(np.max(np.abs(dec - f)))
        check(err <= EPS * (1 + 1e-6) + float(np.spacing(np.float32(np.abs(f).max()))),
              f"auto {name}: max error {err}")
        out[name] = {"bytes": len(files["cuda"]), "chunk_schemes": header["chunk_schemes"],
                     "max_abs_err": err}
    with open(os.path.join(data, "cz2_auto.cz"), "rb") as fh:
        check(fh.read() == files["cuda"], "auto: the card's fixture file is not cz2_auto.cz")
    dec = container.read_field(os.path.join(data, "cz2_auto.cz"), device="cuda")
    want = np.load(os.path.join(data, "cz2_auto.decoded.npy"))
    check(dec.dtype == want.dtype and np.array_equal(dec.view(np.int32), want.view(np.int32)),
          "auto: cz2_auto.cz decoded on the card differs from cz2_auto.decoded.npy")
    return {"cases": out, "card_equals_cpu": True, "fixture_equals_cz2_auto": True,
            "cz2_auto_decodes_bit_exact": True}


def phase_auto_trials(torch, wv, zf, sz, ops, p512) -> dict:
    """The tuner's trials of every ``AUTO_TRIALS_STRIDE``-th chunk of the
    512^3 p, as auto_path makes them, on the card and on the CPU.  Each kernel call of the card's trials
    is recorded (inputs and output copied at the call) and held to its plain
    version on the same inputs, bit for bit; each chunk's trials and ranking
    must equal the CPU's."""
    import threading

    from repro_torch.core import blocks as blk
    from repro_torch.core.pipeline import CompressionSpec, Pipeline
    from repro_torch.kernels.wavelet_pack import pack_plain
    from repro_torch.tune import bound, trial

    plain = {"wavelet_forward": wv.forward3d, "wavelet_inverse": wv.inverse3d,
             "wavelet_pack": pack_plain, "zfpx_encode": zf.encode, "zfpx_decode": zf.decode,
             "lorenzo_encode": sz.encode, "lorenzo_decode": sz.decode}
    real = {name: getattr(ops, name) for name in plain}
    calls, lock = [], threading.Lock()

    def copy(v):
        if isinstance(v, tuple):
            return tuple(copy(t) for t in v)
        return v.clone() if isinstance(v, torch.Tensor) else v

    def recording(name):
        def call(*a, **k):
            out = real[name](*a, **k)
            with lock:
                calls.append((name, copy(a), copy(k), copy(out)))
            return out
        return call

    def sig(a, k) -> str:
        vals = [list(v.shape) if isinstance(v, torch.Tensor) else v for v in a]
        return json.dumps([vals, {kk: v for kk, v in sorted(k.items())}])

    def scores(d) -> list:
        return [(t.scheme, t.eps, t.nbytes, t.max_err, t.psnr, t.admissible, t.error)
                for t in d.trials]

    spec = CompressionSpec(scheme="auto", extra={"target": f"abs={AUTO_TARGET:g}"})
    target = bound.target_from_spec(spec)
    blocks = blk.blockify(p512, spec.block_size)
    host = blocks.cpu().numpy()
    bpc = Pipeline(spec, device="cpu").blocks_per_chunk
    checked = {name: 0 for name in plain}
    inputs = {name: set() for name in plain}
    winners = {}
    for lo in range(0, host.shape[0], bpc * AUTO_TRIALS_STRIDE):
        ci = lo // bpc
        for name in plain:
            setattr(ops, name, recording(name))
        try:
            card = trial.run_trials(blocks[lo:lo + bpc], spec, target, host[lo:lo + bpc])
        finally:
            for name, fn in real.items():
                setattr(ops, name, fn)
        chunk_cpu = torch.from_numpy(host[lo:lo + bpc])
        cpu = trial.run_trials(chunk_cpu, spec, target, host[lo:lo + bpc])
        for name, a, k, out in calls:
            check(_bit_equal(torch, out, plain[name](*a, **k)),
                  f"auto trials, chunk {ci}: {name} at {sig(a, k)} differs from its "
                  "plain version")
            checked[name] += 1
            inputs[name].add(sig(a, k))
        calls.clear()
        check(scores(card) == scores(cpu),
              f"auto trials, chunk {ci}: the card's trials {scores(card)} differ from "
              f"the CPU's {scores(cpu)}")
        check([(c.scheme, c.eps) for c in card.ranked] == [(c.scheme, c.eps) for c in cpu.ranked],
              f"auto trials, chunk {ci}: the card's ranking differs from the CPU's")
        w = f"{card.winner.scheme} eps={card.winner.eps:g}"
        winners[w] = winners.get(w, 0) + 1
    check(all(checked.values()), f"auto trials: a kernel never ran: {checked}")
    return {"chunks": host.shape[0] // bpc, "chunks_checked": sum(winners.values()),
            "target": str(target),
            "kernel_calls_bit_exact": checked,
            "kernel_inputs": {k: sorted(v) for k, v in inputs.items()},
            "trials_equal_cpu": True, "winners": winners}


def _cuda_launches() -> dict:
    """Per kernel row, its wrapper's launches on the card so far
    (``cz_kernel_calls_total{device="cuda"}``)."""
    from repro_torch import obs

    calls = obs.REGISTRY.get("cz_kernel_calls_total")
    return {k: calls.value(kernel=v, device="cuda") for k, v in KERNEL_LABELS.items()}


def _zero_launches(sides: list[dict]) -> None:
    """Set every launch count to 0: per wrapper on the card, and per
    (wrapper, block side) in ``sides``."""
    from repro_torch import obs

    calls = obs.REGISTRY.get("cz_kernel_calls_total")
    for label in KERNEL_LABELS.values():
        calls.set_total(0, kernel=label, device="cuda")
    for c in sides:
        c.clear()


# the kernels line's rows at a block side of their own, and the per-side
# count each reads
SIDE_ROWS = (("wavelet3d_forward_n64", "wavelet3d_forward n=64"),
             ("wavelet3d_inverse_n64", "wavelet3d_inverse n=64"),
             ("lorenzo_decode_n64", "lorenzo_decode n=64"),
             ("wavelet3d_forward_n128", "wavelet3d_forward n=128"),
             ("wavelet3d_inverse_n128", "wavelet3d_inverse n=128"))


def _path_rows(run: dict) -> dict:
    """Each kernels-line row's launches in one path's run: per wrapper from
    ``launches``, and the side rows from ``launches_by_side``."""
    rows = {k: run["launches"][k] for k in KERNEL_LABELS}
    rows.update({row: run["launches_by_side"].get(key, 0) for row, key in SIDE_ROWS})
    return rows


def _tune_series() -> dict:
    """The tuner's series so far: trials per scheme, cache hits, and the
    decision-time histogram."""
    from repro_torch import obs

    snap = obs.snapshot()
    return {k: snap[k]["samples"] for k in ("cz_tune_trials_total", "cz_tune_cache_hits_total",
                                            "cz_tune_decision_seconds") if k in snap}


def _series_delta(before: dict, after: dict) -> dict:
    """``after`` minus ``before`` for :func:`_tune_series` snapshots."""
    out = {}
    for name, rows in after.items():
        old = {json.dumps(r["labels"], sort_keys=True): r for r in before.get(name, [])}
        out[name] = []
        for r in rows:
            o = old.get(json.dumps(r["labels"], sort_keys=True))
            if "value" in r:
                out[name].append({"labels": r["labels"],
                                  "value": r["value"] - (o["value"] if o else 0)})
            else:
                ob = dict(map(tuple, o["buckets"])) if o else {}
                out[name].append({"labels": r["labels"],
                                  "count": r["count"] - (o["count"] if o else 0),
                                  "sum": r["sum"] - (o["sum"] if o else 0.0),
                                  "buckets": [[b if b != float("inf") else "+Inf",
                                               c - ob.get(b, 0)] for b, c in r["buckets"]]})
    return out


def run_cli_path(tmp: str, name: str, scheme_args: list[str], spec: str, bound,
                 kernels: tuple[str, ...], sides: list[dict],
                 qois: tuple[str, ...] = ("p", "rho", "E", "a2"),
                 recorded: str = "jax", keep: str | None = None) -> dict:
    """One 512^3 snapshot through the CLI on the card, every launch count
    (per wrapper, and per wrapper and block side in ``sides``) set to 0
    just before and read just after; each of ``kernels`` must run.
    ``bound(max_abs)`` is
    the scheme's bound for a QoI of that max |x|; ``recorded`` the device
    the header must record.  Returns the footer's chunk mix per QoI and the
    tuner's series of the run too.  ``keep`` is a path the run's p.cz is
    moved to (for region_path) before the rest is removed."""
    from repro_torch.core import container
    from repro_torch.launch import compress

    out = os.path.join(tmp, name)
    tune0 = _tune_series()
    _zero_launches(sides)
    t0 = time.perf_counter()
    report = compress.main(["--source", "cavitation", "--n", str(N_MAIN),
                            "--t", str(T_MAIN), "--qoi", ",".join(qois),
                            "--device", "cuda", "--out", out, *scheme_args])
    total_s = time.perf_counter() - t0
    launches = _cuda_launches()
    by_side = {f"{k} n={n}": v for c in sides for (k, n), v in sorted(c.items())}
    for k in kernels:
        check(launches[k] > 0, f"{k} never launched on the {name} path")
    fields = report["fields"]
    check(list(fields) == list(qois), f"QoIs {list(fields)}")
    mix = {}
    for q, r in fields.items():
        b = bound(r["max_abs"])
        check(r["max_abs_err"] <= b, f"{name} {q}: max error {r['max_abs_err']} > {b}")
        check(r["cr"] > 1 and r["psnr_db"] > 0, f"{name} {q}: CR {r['cr']} PSNR {r['psnr_db']}")
        with open(os.path.join(out, f"{q}.cz"), "rb") as fh:
            header = container._read_header(fh)[0]
        check(header["spec"]["device"] == recorded,
              f"{name} {q} header records {header['spec']['device']}, not {recorded}")
        if "chunk_schemes" in header:
            tally = {}
            for rec in header["chunk_schemes"]:
                key = f"{rec['scheme']} eps={rec['eps']:g}"
                tally[key] = tally.get(key, 0) + 1
            mix[q] = tally
    if keep:
        os.makedirs(os.path.dirname(keep), exist_ok=True)
        os.replace(os.path.join(out, "p.cz"), keep)
    shutil.rmtree(out, ignore_errors=True)
    res = {"n": N_MAIN, "t_us": T_MAIN, "spec": spec, "qois": list(qois),
           "generate_s": report["generate_s"], "total_s": total_s,
           "fields": fields, "launches": launches, "launches_by_side": by_side}
    if mix:
        res["chunk_mix"] = mix
        res["tune"] = _series_delta(tune0, _tune_series())
    return res


# region_path: the p containers kept from the paths, and the kernel that
# decodes each chunk scheme (szx, like raw and fpzipx, has none)
REGION_CONTAINERS = ("wavelet", "zfpx", "lorenzo", "auto")
DECODE_KERNEL = {"wavelet": "wavelet3d_inverse", "zfpx": "zfpx_decode",
                 "lorenzo": "lorenzo_decode"}
# boxes [lo, hi) of the 512^3 field: (a) one block, (b) an unaligned box of
# 4x4x4 blocks in 8 chunks, (c) a two-plane slab across the middle, 16
# chunks, (d) a quarter of the field, 32 chunks (the whole field, 128
# chunks, took 36 s of cold reads over the four containers at prefetch 0 and
# 4; read_field reads it whole through every store)
REGION_BOXES = {"a_block": ((0, 0, 0), (32, 32, 32)),
                "b_unaligned": ((37, 201, 390), (137, 301, 490)),
                "c_slab": ((255, 0, 0), (257, 512, 512)),
                "d_quarter": ((0, 0, 0), (128, 512, 512))}
REGION_LATENCY = 0.002  # the RangeStore's per-request latency, s
# the container also read whole through a FileStore and an HttpStore (the
# store code is the same for every chunk scheme)
REGION_ALL_STORES = "wavelet"
REGION_PREFETCH = 4     # the depth held against prefetch 0 on boxes c and d


def _reader_sums() -> dict:
    """The sums of the reader's fetch and decode histograms so far."""
    from repro_torch import obs

    out = {}
    for name in ("cz_reader_fetch_seconds", "cz_reader_decode_seconds"):
        m = obs.REGISTRY.get(name)
        out[name] = m.snapshot()["sum"] if m is not None else 0.0
    return out


def cli(*argv) -> tuple[int, str]:
    """The port's CLI (``repro_torch.launch.compress.main``) run in-process
    on ``argv``: its exit code and what it printed."""
    from repro_torch.launch import compress

    shown, code = io.StringIO(), None
    with contextlib.redirect_stdout(shown):
        try:
            compress.main(list(argv))
        except SystemExit as e:
            code = e.code
    return code, shown.getvalue()


def _launch_counter(phase: str, sides: list[dict]):
    """``counted(expected, what, fn)`` for one phase: runs ``fn`` with every
    launch count set to 0 just before, checks the launches read just after
    against ``expected`` (per kernel row; absent rows 0) and adds them to
    the phase's totals; the pack's expectation, unless given, is the
    forward transform's (stage 1 launches one after each).  It returns
    ``fn``'s value, its seconds and the launches in all.  The totals (per
    wrapper, and per wrapper and block side) come back beside ``counted``,
    in the shape ``_path_rows`` reads."""
    totals = dict.fromkeys(KERNEL_LABELS, 0)
    by_side: dict = {}

    def counted(expected: dict, what: str, fn):
        _zero_launches(sides)
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        launches = _cuda_launches()
        want = {k: expected.get(k, 0) for k in KERNEL_LABELS}
        want["wavelet_pack"] = expected.get("wavelet_pack", want["wavelet3d_forward"])
        check(launches == want, f"{phase} {what}: launches {launches}, expected {want}")
        for k, v in launches.items():
            totals[k] += v
        for c in sides:
            for (k, n), v in c.items():
                by_side[f"{k} n={n}"] = by_side.get(f"{k} n={n}", 0) + v
        return out, dt, sum(launches.values())

    return counted, {"launches": totals, "launches_by_side": by_side}


def phase_region(files: dict, sides: list[dict]) -> tuple[dict, dict]:
    """Random access to the 512^3 p containers on the card.  For each
    container (wavelet, zfpx, lorenzo; auto, whose chunks are szx):
    ``describe(verify=True)`` and ``inspect``; ``read_field(device="cuda")``
    through a MemoryStore (the reference read) and a RangeStore with 2 ms
    per request, and for the wavelet container also through a FileStore and
    an HttpStore on a loopback StaticFileServer, each bit-equal to the
    reference read; then ``FieldReader`` on a fresh RangeStore (2 ms) per
    box, cold then warm, each bit-equal to the same slice of the reference
    read, with ``chunks_decoded`` the box's chunks; boxes c and d again at
    prefetch 4: the same bits, requests and bytes fetched.  Every read runs
    with the launch counts set to 0 just before and read just after: the
    decode kernel of each chunk's scheme launches once per chunk decoded,
    and no kernel on a warm read.  Returns the per-container results and
    the launches summed over every read (per wrapper, and per wrapper and
    block side)."""
    import numpy as np

    from repro_torch.core import container
    from repro_torch.store import backends as stores

    counted, launched = _launch_counter("region_path", sides)

    results = {}
    for name in REGION_CONTAINERS:
        path = files[name]
        d = container.describe(path, verify=True)
        check(d["crc_ok"] is True, f"region_path {name}: describe reports a CRC mismatch")
        schemes = [row.get("scheme", d["scheme"]) for row in d["chunks"]]
        nchunks = len(schemes)

        def expect(cis):
            e = {}
            for ci in cis:
                k = DECODE_KERNEL.get(schemes[ci])
                if k:
                    e[k] = e.get(k, 0) + 1
            return e

        code, _shown = cli("inspect", path)
        check(code == 0, f"region_path {name}: inspect exited {code}")
        with open(path, "rb") as fh:
            blob = fh.read()
        root, key = os.path.split(path)
        mem, rng = stores.MemoryStore(), stores.RangeStore(latency=REGION_LATENCY)
        mem.put(key, blob)
        rng.put(key, blob)
        read_s = {}
        ref, read_s["mem"], _ = counted(
            expect(range(nchunks)), f"{name} read_field over mem",
            lambda: container.read_field(key, device="cuda", store=mem))
        check(ref.dtype == np.float32 and ref.shape == (N_MAIN,) * 3,
              f"region_path {name}: read_field gave {ref.dtype} {ref.shape}")
        bits = ref.view(np.int32)
        with contextlib.ExitStack() as stack:
            others = [("range_2ms", rng)]
            if name == REGION_ALL_STORES:
                srv = stack.enter_context(stores.StaticFileServer(root))
                others += [("file", stores.FileStore(root)),
                           ("http", stack.enter_context(stores.HttpStore(srv.url)))]
            for kind, st in others:
                got, read_s[kind], _ = counted(
                    expect(range(nchunks)), f"{name} read_field over {kind}",
                    lambda st=st: container.read_field(key, device="cuda", store=st))
                check(got.dtype == ref.dtype and np.array_equal(got.view(np.int32), bits),
                      f"region_path {name}: read_field over {kind} differs from the "
                      f"MemoryStore read")
                del got
        boxes = {}
        for bname, (lo, hi) in REGION_BOXES.items():
            want = bits[tuple(slice(a, b) for a, b in zip(lo, hi))]
            runs = {}
            for pf in (0, REGION_PREFETCH) if bname in ("c_slab", "d_quarter") else (0,):
                st = stores.RangeStore(latency=REGION_LATENCY)
                st.put(key, blob)
                tag = f"{name} box {bname} prefetch {pf}"
                with container.FieldReader(key, cache_chunks=nchunks, device="cuda", store=st,
                                           prefetch=pf) as r:
                    cis = r.box_chunks(lo, hi)
                    sums0, st0 = _reader_sums(), st.stats()
                    box, cold_s, cold_n = counted(expect(cis), f"{tag} cold",
                                                  lambda: r.read_box(lo, hi))
                    sums1, st1 = _reader_sums(), st.stats()
                    check(np.array_equal(box.view(np.int32), want),
                          f"region_path {tag}: read_box differs from the MemoryStore read")
                    check(r.chunks_decoded == len(cis),
                          f"region_path {tag}: {r.chunks_decoded} chunks decoded, box has {len(cis)}")
                    hits0 = r.cache_hits
                    box, warm_s, warm_n = counted({}, f"{tag} warm",
                                                  lambda: r.read_box(lo, hi))
                    check(np.array_equal(box.view(np.int32), want),
                          f"region_path {tag}: the warm read_box differs")
                    check(r.chunks_decoded == len(cis)
                          and r.cache_hits - hits0 == len(r.box_blocks(lo, hi)),
                          f"region_path {tag}: the warm read was not all cache hits")
                    del box
                runs[pf] = {
                    "cold_ms": cold_s * 1e3, "warm_ms": warm_s * 1e3,
                    "chunks_decoded": r.chunks_decoded,
                    "launches": cold_n, "warm_launches": warm_n,
                    **{f"{k}_sum": sums1[k] - sums0[k] for k in sums0},
                    "get_requests": st1["get_requests"] - st0["get_requests"],
                    "bytes_fetched": st1["bytes_fetched"] - st0["bytes_fetched"]}
            if REGION_PREFETCH in runs:
                a, b = runs[0], runs[REGION_PREFETCH]
                check((a["get_requests"], a["bytes_fetched"]) == (b["get_requests"],
                                                                  b["bytes_fetched"]),
                      f"region_path {name} box {bname}: prefetch changed requests or bytes "
                      f"{a} {b}")
            boxes[bname] = {"lo": lo, "hi": hi, "chunks": len(cis), **runs.pop(0)}
            if runs:
                boxes[bname][f"prefetch{REGION_PREFETCH}"] = runs[REGION_PREFETCH]
        results[name] = {"bytes": len(blob), "chunks": nchunks,
                         "chunk_schemes": {s_: schemes.count(s_) for s_ in sorted(set(schemes))},
                         "crc_ok": True, "inspect_exit": code,
                         "read_field_s": read_s, "boxes": boxes}
        del ref, bits
    return results, launched


# dataset_path: the worker counts of the two appends, and the box read back
# through the dataset (region_path's unaligned box: 8 chunks)
DATASET_WORKERS = (1, 4)
DATASET_BOX = "b_unaligned"


DATASET_SPANS = ("dataset.write", "stage1", "encode", "dataset.stats_read", "decode",
                 "dataset.member_stats", "dataset.commit")


def _span_walls(events: list[dict]) -> dict:
    """Wall seconds from the first start to the last end of each span in
    ``DATASET_SPANS`` (an append's steps, and within them the pipeline's
    ``stage1`` and the chunks' ``encode`` and ``decode``, across threads)
    in one append's trace events."""
    walls = {}
    for name in DATASET_SPANS:
        evs = [e for e in events if e["name"] == name]
        check(bool(evs), f"no {name} span in the trace")
        walls[name] = (max(e["ts"] + e["dur"] for e in evs) - min(e["ts"] for e in evs)) / 1e6
    return walls


def phase_dataset(tmp: str, p512, wavelet_file: str, sides: list[dict],
                  keep: str | None = None) -> dict:
    """The dataset store on the card: the 512^3 p (already on the card,
    copied to the host once: ``append`` takes numpy) appended at
    t = T_MAIN into a FileStore ``CZDataset`` with the default spec,
    ``stats=True`` and ``device="cuda"``, once at ``workers=1`` and once at
    ``workers=4`` (a new dataset each).  The two members are byte-identical,
    and their chunks are those of main_path's p (``wavelet_file``); the
    manifests' psnr and max_err are equal, max_err <= 100 eps.  Each append
    launches the forward once and the inverse once per chunk (the stats
    decode).  Each append runs with the trace on, and its seconds are split
    by its spans (first start to last end, across the pool's threads): the
    member's write, and within it stage 1 and the chunks' encodes; the
    stats read, and within it the chunks' decodes; the psnr/max_err pass;
    the manifest's commit; and the rest of the append.  Then the
    ``workers=4`` dataset's keys go into a RangeStore
    with 2 ms per request, and ``read_box`` of region_path's unaligned 100^3
    box through ``CZDataset(store, device="cuda")``, cold then warm, equals
    ``FieldReader(wavelet_file).read_box`` bit for bit, with one inverse
    launch per chunk decoded (8 cold, 0 warm) and ``ds.stats()`` agreeing.
    Last the CLI on the first dataset: ``inspect``, ``inspect --stats`` and
    ``inspect --json`` exit 0; with an orphaned member and a stale ``.tmp``
    planted, ``gc --dry-run`` lists exactly those two, ``gc`` deletes them,
    and a second dry run finds the dataset clean.  Every step runs with the
    launch counts set to 0 just before and read just after.  Returns the
    phase's results and its launches summed (per wrapper, and per wrapper
    and block side).  ``keep`` is a path the ``workers=4`` dataset is moved
    to (for serve_path) before the rest is removed."""
    import math

    import numpy as np

    from repro_torch.core import container
    from repro_torch.core.pipeline import STAGE_SECONDS, CompressionSpec
    from repro_torch.obs import trace
    from repro_torch.store import CZDataset, FileStore, RangeStore

    counted, launched = _launch_counter("dataset_path", sides)

    host = p512.cpu().numpy()
    ref_chunks = [c for c, _n in container.iter_compressed(wavelet_file)]
    nchunks = len(ref_chunks)
    check(nchunks == math.ceil((N_MAIN // 32) ** 3 / 32),
          f"dataset_path: main_path's p has {nchunks} chunks")
    roots, appends, members, records = {}, {}, {}, {}
    for w in DATASET_WORKERS:
        roots[w] = os.path.join(tmp, "dataset", f"w{w}")
        with CZDataset(roots[w], "a", spec=CompressionSpec(), workers=w, stats=True,
                       device="cuda") as ds:
            before = dict(STAGE_SECONDS)
            trace.reset()
            trace.enable()
            t, append_s, _ = counted({"wavelet3d_forward": 1, "wavelet3d_inverse": nchunks},
                                  f"append at workers={w}",
                                  lambda ds=ds: ds.append({"p": host}, time=T_MAIN))
            trace.disable()
            spans = _span_walls(trace.TRACER.events())
            trace.reset()
            stage = {k: v - before[k] for k, v in STAGE_SECONDS.items()}
            check(t == 0, f"dataset_path: the first append was given timestep {t}")
            records[w] = ds.timestep_info("p", 0)
        with open(os.path.join(roots[w], "p", "t000000.cz"), "rb") as fh:
            members[w] = fh.read()
        appends[f"workers{w}"] = {
            "append_s": append_s,
            "stage_s": {k: stage[k] for k in ("stage1", "serialize", "stage2_encode")},
            "stats_decode_s": stage["stage2_decode"] + stage["deserialize"],
            "wall_s": {
                "write": spans["dataset.write"], "stage1": spans["stage1"],
                "encode": spans["encode"],
                "write_rest": spans["dataset.write"] - spans["stage1"] - spans["encode"],
                "stats_read": spans["dataset.stats_read"], "decode": spans["decode"],
                "stats_read_rest": spans["dataset.stats_read"] - spans["decode"],
                "member_stats": spans["dataset.member_stats"],
                "commit": spans["dataset.commit"],
                "rest": append_s - sum(spans[k] for k in (
                    "dataset.write", "dataset.stats_read", "dataset.member_stats",
                    "dataset.commit"))},
            "bytes": records[w]["bytes"], "psnr": records[w]["psnr"],
            "max_err": records[w]["max_err"]}
    check(members[1] == members[4], "dataset_path: the workers=1 and workers=4 members differ")
    got = [c for c, _n in container.iter_compressed("p/t000000.cz",
                                                    store=FileStore(roots[4]))]
    check(got == ref_chunks, "dataset_path: the members' chunks differ from main_path's p")
    check((records[1]["psnr"], records[1]["max_err"]) == (records[4]["psnr"],
                                                         records[4]["max_err"]),
          f"dataset_path: the manifests' stats differ: {records[1]} {records[4]}")
    check(records[1]["max_err"] <= 100 * EPS,
          f"dataset_path: max_err {records[1]['max_err']} > {100 * EPS}")
    check(records[1]["raw_bytes"] == host.nbytes and records[1]["time"] == T_MAIN,
          f"dataset_path: timestep record {records[1]}")

    src = FileStore(roots[4])
    st = RangeStore(latency=REGION_LATENCY)
    for key in src.list(""):
        st.put(key, src.get(key))
    lo, hi = REGION_BOXES[DATASET_BOX]
    with container.FieldReader(wavelet_file, device="cuda") as r:
        want = r.read_box(lo, hi).view(np.int32)
        cis = r.box_chunks(lo, hi)
        nblk = len(r.box_blocks(lo, hi))
    with CZDataset(st, device="cuda") as ds:
        st0 = st.stats()
        box, cold_s, _ = counted({"wavelet3d_inverse": len(cis)}, "read_box cold",
                              lambda: ds.read_box("p", 0, lo, hi))
        check(np.array_equal(box.view(np.int32), want),
              "dataset_path: the cold read_box differs from FieldReader's")
        box, warm_s, _ = counted({}, "read_box warm", lambda: ds.read_box("p", 0, lo, hi))
        check(np.array_equal(box.view(np.int32), want),
              "dataset_path: the warm read_box differs from FieldReader's")
        st1 = st.stats()
        stats = ds.stats()
        check(stats == {"open_readers": 1, "chunks_decoded": len(cis),
                        "cache_hits": 2 * nblk - len(cis), "cache_misses": len(cis),
                        "cache_hit_rate": (2 * nblk - len(cis)) / (2 * nblk)},
              f"dataset_path: ds.stats() {stats} for {len(cis)} chunks, {nblk} blocks")
    region = {"box": DATASET_BOX, "lo": lo, "hi": hi, "chunks": len(cis),
              "cold_ms": cold_s * 1e3, "warm_ms": warm_s * 1e3, "stats": stats,
              "get_requests": st1["get_requests"] - st0["get_requests"],
              "bytes_fetched": st1["bytes_fetched"] - st0["bytes_fetched"]}

    root = roots[1]
    t0 = time.perf_counter()
    runs = {}  # each CLI call's exit code and output

    def run(label: str, *argv):
        runs[label] = counted({}, label, lambda: cli(*argv, root))[0]
        return runs[label]

    for flags in ([], ["--stats"], ["--json"]):
        run(" ".join(["inspect", *flags]), "inspect", *flags)
    check(all(code == 0 for code, _out in runs.values()),
          f"dataset_path: inspect exit codes {[c for c, _o in runs.values()]}")
    check(json.loads(runs["inspect --json"][1])["members"]["p/t000000.cz"]["crc_ok"] is True,
          "dataset_path: inspect --json reports a CRC mismatch")
    planted = ["manifest.json.tmp", "p/t000009.cz"]
    for key in planted:
        with open(os.path.join(root, key), "wb") as fh:
            fh.write(b"orphan")
    dry = run("gc --dry-run", "gc", "--dry-run")
    check(dry == (0, "".join(f"would delete {k}\n" for k in planted) + "2 orphan(s) found\n"),
          f"dataset_path: gc --dry-run gave {dry}")
    gone = run("gc", "gc")
    check(gone == (0, "".join(f"deleted {k}\n" for k in planted) + "2 orphan(s) deleted\n"),
          f"dataset_path: gc gave {gone}")
    check(not any(os.path.exists(os.path.join(root, k)) for k in planted),
          "dataset_path: gc left a planted orphan")
    again = run("gc --dry-run after gc", "gc", "--dry-run")
    check(again == (0, "dataset clean — no orphans\n"),
          f"dataset_path: the second gc --dry-run gave {again}")
    cli_s = time.perf_counter() - t0
    if keep:
        os.replace(roots[4], keep)
    shutil.rmtree(os.path.join(tmp, "dataset"), ignore_errors=True)
    return {"n": N_MAIN, "t_us": T_MAIN, "spec": "CompressionSpec() defaults, stats=True",
            "chunks": nchunks, "cpu_count": os.cpu_count(),
            "sched_affinity": len(os.sched_getaffinity(0)), "appends": appends,
            "members_identical": True, "chunks_equal_main_path": True,
            "region_read": region, "cli_s": cli_s,
            "cli_exit": {label: code for label, (code, _out) in runs.items()},
            **launched}


# parallel_path: the rank counts of the 512^3 p, and of the device-spec
# checks on a 128^3 cube from the middle of it (one 32^3 block per chunk:
# 64 chunks, so every rank has a span)
PARALLEL_RANKS = (2, 4)
PARALLEL_SPEC_RANKS = (1, 2, 4)
PARALLEL_CUBE = slice(192, 320)
PARALLEL_BUFFER = 1 << 17
# each device scheme's encode and decode rows, and its bound for a max |x|
PARALLEL_SCHEMES = {"wavelet": ("wavelet3d_forward", "wavelet3d_inverse", lambda _m: 100 * EPS),
                    "zfpx": ("zfpx_encode", "zfpx_decode", lambda _m: ZFPX_BOUND),
                    "lorenzo": ("lorenzo_encode", "lorenzo_decode", lorenzo_bound)}
CLUSTER_PHASES = ("encode", "exscan", "commit")
# the planes of p pickled through the pool's pipe for comparison (32 MiB)
PIPE_PLANES = 32


def _traced(fn):
    """``fn()`` with the process tracer on: its value and the trace's
    events (the ranks' tracks absorbed onto ``pid`` 0, 1, ...)."""
    from repro_torch.obs import trace

    trace.reset()
    trace.enable()
    try:
        out = fn()
    finally:
        trace.disable()
    events = trace.TRACER.events()
    trace.reset()
    return out, events


def _cluster_phase_sums() -> dict:
    """The sums of ``cz_cluster_phase_seconds`` so far, per phase."""
    from repro_torch import obs

    h = obs.REGISTRY.get("cz_cluster_phase_seconds")
    return {p: h.snapshot(phase=p)["sum"] for p in CLUSTER_PHASES}


def _overlap_s(intervals: list[tuple[float, float]]) -> float:
    """Seconds during which two or more of the ``[start, end)`` intervals
    (us) run at once."""
    edges = sorted([(a, 1) for a, _b in intervals] + [(b, -1) for _a, b in intervals])
    depth, last, total = 0, 0.0, 0.0
    for t, step in edges:
        if depth >= 2:
            total += t - last
        depth += step
        last = t
    return total / 1e6


def _rank_tracks(events: list[dict], nranks: int, row: str, what: str) -> list[dict]:
    """Each rank's track in a compress's absorbed trace: its ``encode``
    span, whose launch counts (read in the rank's own process, from its
    wrappers' launch sites, across the encode) must be exactly one launch
    of ``row``'s kernel (and, for the wavelet forward, one of the pack
    after it), and those kernels' ``kernel.*`` spans on the card, the
    first for its timing.  Returns per rank its launches (per wrapper and per
    side), its encode wall and stage seconds, its stage 1 and kernel spans
    (us on the parent's timeline) and its commit wall."""
    out = []
    for r in range(nranks):
        mine = [e for e in events if e.get("pid") == r and e.get("ph") == "X"]
        enc = [e for e in mine if e["name"] == "encode" and e.get("args", {}).get("rank") == r]
        check(len(enc) == 1, f"parallel_path {what}: rank {r} has {len(enc)} encode spans")
        launches = enc[0]["args"]["launches"]
        labels = [KERNEL_LABELS[row]] + (["wavelet_pack"] if row == "wavelet3d_forward" else [])
        check(launches == dict.fromkeys(labels, 1),
              f"parallel_path {what}: rank {r} launched {launches}, not one {labels} on the card")
        calls = [(e["args"]["kernel"], e["args"]["device"]) for e in mine
                 if e["name"].startswith("kernel.")]
        check(calls == [(k, "cuda") for k in labels],
              f"parallel_path {what}: rank {r}'s kernel spans {calls}, not one {labels} on cuda")
        kern = next(e for e in mine if e["name"].startswith("kernel."))
        s1 = [e for e in mine if e["name"] == "stage1"]
        check(len(s1) == 1, f"parallel_path {what}: rank {r} has {len(s1)} stage1 spans")
        out.append({"rank": r, "nblocks": enc[0]["args"]["nblocks"], "launches": launches,
                    "launches_by_side": enc[0]["args"]["launches_by_side"],
                    "span_read_s": sum(e["dur"] for e in mine if e["name"] == "span_read") / 1e6,
                    "encode_s": enc[0]["dur"] / 1e6, "stage_s": enc[0]["args"]["stage_s"],
                    "stage1_us": (s1[0]["ts"], s1[0]["ts"] + s1[0]["dur"]),
                    "kernel_us": (kern["ts"], kern["ts"] + kern["dur"]),
                    "commit_s": sum(e["dur"] for e in mine if e["name"] == "commit") / 1e6})
    return out


def _parent_span_s(events: list[dict], name: str) -> float:
    """Seconds of the parent's ``name`` spans (the ranks' tracks are pids
    below the rank count; the parent's is its OS pid)."""
    pid = os.getpid()
    return sum(e["dur"] for e in events
               if e.get("pid") == pid and e["name"] == name and e.get("ph") == "X") / 1e6


def staging_fs() -> dict:
    """The system's temporary directory, where the engine stages the ranks'
    spans, and the file system it lies on (``/proc/mounts``)."""
    import tempfile

    tmp = os.path.realpath(tempfile.gettempdir())
    mounts = []
    with open("/proc/mounts") as f:
        for line in f:
            dev, mnt, fstype = line.split()[:3]
            if tmp == mnt or tmp.startswith(mnt.rstrip("/") + "/"):
                mounts.append((len(mnt), mnt, fstype, dev))
    _n, mnt, fstype, dev = max(mounts)
    return {"dir": tmp, "mount": mnt, "fstype": fstype, "device": dev}


def smi_apps() -> str:
    """The card's compute processes and their memory (nvidia-smi)."""
    return subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def phase_parallel(tmp: str, p512, wavelet_file: str, sides: list[dict]) -> dict:
    """The cluster tier on the card (``repro_torch.cluster``), run after
    dataset_path on the 512^3 p it left on the card.  One
    ``ParallelCompressor(4, device="cuda")`` (four spawned ranks, each with
    its own CUDA context on the card) serves every compress below.

    1. Boot: the pool's first compress (the 128^3 cube from the middle of
       p, wavelet, 64 chunks, ranks 4), which starts the four ranks, and the
       same compress again, warm.
    2. Device specs: under wavelet, zfpx and lorenzo (eps 1e-3, 32^3 blocks,
       one block per chunk), the cube's shared file at ranks 1, 2 and 4 is
       byte-identical to ``container.write_field(..., device="cuda")`` and
       decodes on the card within the scheme's bound; each rank's trace
       shows its ``encode`` span and one launch of the scheme's encode
       kernel on the card (ranks 1: the parent's launch, in-process).
    3. The paper's mechanism at full size: p (the default spec, 128
       chunks) at ranks 2 and 4, each file byte-identical to main_path's p
       container; per rank count the wall, the parent's
       ``cz_cluster_phase_seconds`` per phase and its span copy to the host,
       each rank's encode wall, stage seconds, stage 1 and kernel spans and
       commit; while the pool is warm, the card's compute processes and
       their memory (nvidia-smi) and the ranks' pids, and the card memory
       the ranks hold: the card's free memory (``torch.cuda.mem_get_info``)
       before the pool started less that while it is warm, less what this
       process reserved meanwhile.
    4. ``RankWriter``: two ranks (``stats=True``, ``device="cuda"``) append
       the cube as p and the first 128^3 corner as rho at t = 0 to a new
       FileStore dataset with the default spec; ``merge_manifests`` folds
       both; ``CZDataset(device="cuda")`` lists both, reads each back
       within 100 eps, no sidecar is left, and ``gc --dry-run`` finds the
       dataset clean.
    5. The CLI in-process: ``parallel --ranks 4 --n 128 --qoi p
       --check-identical --device cuda`` (its own pool) exits 0 and prints
       ``bit-identical``.

    Every step runs with the launch counts set to 0 just before and read
    just after (the parent's launches: the serial writes, the read-backs,
    ranks 1); the ranks' launches are the counts each rank read from its
    own launch sites across its encode, carried on its ``encode`` span.
    After the p runs, 32 MiB of p pickled through the pool's pipe to a rank
    (the reference's handoff) against the staging files' rates, and the
    file system of the staging directory.
    Prints the boot's line and one per rank count of p; returns the
    phase's result with its launches (parent and ranks, per kernel row)."""
    import numpy as np
    import torch

    from repro_torch.cluster import ParallelCompressor, RankWriter, merge_manifests
    from repro_torch.core import container
    from repro_torch.core.pipeline import CompressionSpec
    from repro_torch.store import CZDataset

    counted, launched = _launch_counter("parallel_path", sides)
    rank_launches = dict.fromkeys(KERNEL_LABELS, 0)
    rank_sides: dict = {}
    row_of = {label: row for row, label in KERNEL_LABELS.items()}

    def ranked(tracks: list[dict]) -> None:
        """Add the ranks' launch-site counts of one compress."""
        for t in tracks:
            for label, n in t["launches"].items():
                rank_launches[row_of[label]] += n
            for key, n in t["launches_by_side"].items():
                rank_sides[key] = rank_sides.get(key, 0) + n

    root = os.path.join(tmp, "parallel")
    os.makedirs(root)
    cube = p512[PARALLEL_CUBE, PARALLEL_CUBE, PARALLEL_CUBE].contiguous()
    cube_np = cube.cpu().numpy()
    ref_bytes = open(wavelet_file, "rb").read()
    host = {"cpu_count": os.cpu_count(), "sched_affinity": len(os.sched_getaffinity(0))}
    torch.cuda.synchronize()
    free0, reserved0 = torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved()
    with ParallelCompressor(4, device="cuda") as pc:
        # 1. boot: the pool's first compress, then the same one warm
        spec = CompressionSpec(buffer_bytes=PARALLEL_BUFFER)
        path = os.path.join(root, "boot.cz")
        boot = {}
        for label in ("first", "warm"):
            (_n, evs), boot[f"{label}_s"], _ = counted(
                {}, f"boot {label}", lambda: _traced(lambda: pc.compress(path, cube, spec)))
            ranked(_rank_tracks(evs, 4, "wavelet3d_forward", f"boot {label}"))
        boot["boot_s"] = boot["first_s"] - boot["warm_s"]
        emit({"phase": "parallel_path", "part": "boot", **boot, **host,
                      "what": "the pool's first compress (128^3 cube, ranks 4, 64 chunks: "
                              "four spawned ranks, each its torch import and CUDA context) "
                              "and the same compress warm"})

        # 2. the device specs at ranks 1, 2 and 4 on the cube
        specs = {}
        for scheme, (enc, dec, bound) in PARALLEL_SCHEMES.items():
            spec = CompressionSpec(scheme=scheme, buffer_bytes=PARALLEL_BUFFER)
            serial = os.path.join(root, f"{scheme}.serial.cz")
            _n, serial_s, _ = counted({enc: 1}, f"{scheme} serial write",
                                      lambda: container.write_field(serial, cube, spec,
                                                                    device="cuda"))
            want = open(serial, "rb").read()
            res = {"serial_s": serial_s, "bytes": len(want)}
            for ranks in PARALLEL_SPEC_RANKS:
                path = os.path.join(root, f"{scheme}.r{ranks}.cz")
                (_n, evs), res[f"ranks{ranks}_s"], _ = counted(
                    {enc: 1} if ranks == 1 else {}, f"{scheme} ranks={ranks}",
                    lambda: _traced(lambda: pc.compress(path, cube, spec, ranks=ranks)))
                check(open(path, "rb").read() == want,
                      f"parallel_path: {scheme} at ranks={ranks} differs from the serial writer")
                if ranks > 1:
                    ranked(_rank_tracks(evs, ranks, enc, f"{scheme} ranks={ranks}"))
            nchunks = len(container.describe(path)["chunks"])
            got, read_s, _ = counted({dec: nchunks}, f"{scheme} read",
                                     lambda: container.read_field(path, device="cuda"))
            err = float(np.max(np.abs(got - cube_np)))
            b = bound(float(np.max(np.abs(cube_np))))
            check(err <= b, f"parallel_path: {scheme} max error {err} > {b}")
            specs[scheme] = {**res, "read_s": read_s, "chunks": nchunks, "max_err": err,
                             "bound": b, "files_identical": True}
            for name in os.listdir(root):
                os.unlink(os.path.join(root, name))

        # 3. the 512^3 p at ranks 2 and 4 against main_path's p container
        spec = CompressionSpec()
        path = os.path.join(root, "p.cz")
        full = {}
        for ranks in PARALLEL_RANKS:
            before = _cluster_phase_sums()
            (nbytes, evs), wall_s, _ = counted(
                {}, f"p512 ranks={ranks}",
                lambda: _traced(lambda: pc.compress(path, p512, spec, ranks=ranks)))
            check(open(path, "rb").read() == ref_bytes,
                  f"parallel_path: the 512^3 p at ranks={ranks} differs from main_path's")
            tracks = _rank_tracks(evs, ranks, "wavelet3d_forward", f"p512 ranks={ranks}")
            ranked(tracks)
            after = _cluster_phase_sums()
            full[ranks] = {
                "ranks": ranks, "wall_s": wall_s, "bytes": nbytes,
                "phase_s": {p: after[p] - before[p] for p in CLUSTER_PHASES},
                "host_copy_s": _parent_span_s(evs, "host_copy"),
                "span_write_s": _parent_span_s(evs, "span_write"),
                "stage1_overlap_s": _overlap_s([t["stage1_us"] for t in tracks]),
                "kernel_overlap_s": _overlap_s([t["kernel_us"] for t in tracks]),
                "per_rank": [{"rank": t["rank"], "nblocks": t["nblocks"],
                              "span_read_s": t["span_read_s"],
                              "encode_s": t["encode_s"], "stage_s": t["stage_s"],
                              "kernel_ms": (t["kernel_us"][1] - t["kernel_us"][0]) / 1e3,
                              "commit_s": t["commit_s"]} for t in tracks],
                "identical_to_main_path": True}
            if ranks == max(PARALLEL_RANKS):  # the pool is warm: each context's memory
                torch.cuda.synchronize()
                held = free0 - torch.cuda.mem_get_info()[0] - (
                    torch.cuda.memory_reserved() - reserved0)
                full[ranks]["ranks_card_mib"] = {"all": held / 2**20, "per_rank": held / 2**20 / 4}
                full[ranks]["compute_apps"] = smi_apps()
                full[ranks]["pids"] = {"parent": os.getpid(), "ranks": sorted(
                    p.pid for p in multiprocessing.active_children())}
            os.unlink(path)
            emit({"phase": "parallel_path", "part": "p512", **full[ranks], **host})

        # the reference's handoff, for comparison: a span pickled through the
        # pool's one pipe to a rank, against the staging files' rates above
        span = p512[:PIPE_PLANES].cpu().numpy()
        t0 = time.perf_counter()
        got = pc._get_pool().apply(len, (span,))
        pipe_s = time.perf_counter() - t0
        check(got == PIPE_PLANES, f"parallel_path: the pipe delivered {got} planes")
        mib, wide = span.nbytes / 2**20, full[max(PARALLEL_RANKS)]
        handoff = {"pipe_mib": mib, "pipe_s": pipe_s, "pipe_mib_s": mib / pipe_s,
                   "file_write_mib_s": p512.numel() * 4 / 2**20 / wide["span_write_s"],
                   "file_read_mib_s": min(r["nblocks"] * 32**3 * 4 / 2**20 / r["span_read_s"]
                                          for r in wide["per_rank"]),
                   "staging": staging_fs()}
        emit({"phase": "parallel_path", "part": "handoff", **handoff})

    # 4. RankWriter: two ranks append, one merge
    ds_root = os.path.join(root, "dataset")
    with CZDataset(ds_root, "a", spec=CompressionSpec(), device="cuda"):
        pass
    corner = p512[:128, :128, :128].cpu().numpy()
    cubes = {"p": cube_np, "rho": corner}
    nchunks = 2  # 64 blocks of 32^3 at 32 per 4 MiB chunk
    writes = {}
    for rank, q in enumerate(cubes):
        with RankWriter(ds_root, rank, stats=True, device="cuda") as w:
            _t, writes[q], _ = counted({"wavelet3d_forward": 1, "wavelet3d_inverse": nchunks},
                                       f"RankWriter {rank} append",
                                       lambda: w.append({q: cubes[q]}, t=0, time=T_MAIN))
    merged, merge_s, _ = counted({}, "merge_manifests", lambda: merge_manifests(ds_root))
    check(merged == 2, f"parallel_path: merge_manifests merged {merged} entries")
    check(not any(n.startswith("manifest.rank") for n in os.listdir(ds_root)),
          f"parallel_path: sidecars left after the merge: {os.listdir(ds_root)}")
    records = {}
    with CZDataset(ds_root, device="cuda") as ds:
        check(ds.quantities == ["p", "rho"], f"parallel_path: quantities {ds.quantities}")
        for q, want in cubes.items():
            got, _s, _ = counted({"wavelet3d_inverse": nchunks}, f"dataset read {q}",
                                 lambda: ds.read_field(q, 0))
            err = float(np.max(np.abs(got - want)))
            check(err <= 100 * EPS, f"parallel_path: dataset {q} max error {err}")
            records[q] = {**ds.timestep_info(q, 0), "read_max_err": err}
    gc = counted({}, "gc --dry-run", lambda: cli("gc", "--dry-run", ds_root))[0]
    check(gc == (0, "dataset clean — no orphans\n"), f"parallel_path: gc --dry-run gave {gc}")
    rank_writer = {"append_s": writes, "merge_s": merge_s, "records": records,
                   "gc_dry_run": gc[1].strip()}

    # 5. the CLI, with its own pool
    out = os.path.join(root, "cli")
    (res, evs), cli_s, _ = counted(
        {"wavelet3d_forward": 1, "wavelet3d_inverse": 8}, "CLI parallel",
        lambda: _traced(lambda: cli("parallel", "--ranks", "4", "--n", "128", "--qoi", "p",
                                    "--check-identical", "--device", "cuda", "--out", out)))
    code, text = res
    check(code == 0 and "[bit-identical]" in text,
          f"parallel_path: the CLI's parallel gave {code}: {text}")
    ranked(_rank_tracks(evs, 4, "wavelet3d_forward", "CLI parallel"))
    shutil.rmtree(root, ignore_errors=True)
    for k, v in rank_launches.items():
        launched["launches"][k] += v
    for k, v in rank_sides.items():
        launched["launches_by_side"][k] = launched["launches_by_side"].get(k, 0) + v
    return {"n": N_MAIN, "t_us": T_MAIN, "spec": "CompressionSpec() defaults",
            "cube": [PARALLEL_CUBE.start, PARALLEL_CUBE.stop], "boot": boot,
            "device_specs": specs, "p512": full, "handoff": handoff,
            "rank_writer": rank_writer,
            "cli": {"exit": code, "out": text.strip(), "s": cli_s},
            "rank_launches": rank_launches, **host, **launched}


# serve_path: the region server over dataset_path's 512^3 p (wavelet) and
# two 128^3 datasets of parallel_path's cube (zfpx, lorenzo)
SERVE_SCHEMES = ("zfpx", "lorenzo")
# full depth along x at by = 1: 16 chunks, none of box b's
SERVE_COLUMN = ((0, 32, 256), (512, 64, 288))
SERVE_SHIFTED = ((40, 205, 400), (130, 300, 480))  # box b's 8 chunks, other blocks
SERVE_SMALL_BOX = ((10, 20, 30), (110, 120, 100))  # both chunks of a 128^3 member
SERVE_COALESCED = 16        # clients released onto one cold box
SERVE_LEVELS = (1, 4, 16)   # concurrent clients of the decode-lock measurement
SERVE_LOCK_BOXES = 32       # distinct cold 64^3 boxes per level (2 chunks each)


def _http_get(url: str, path: str) -> tuple[int, dict, bytes]:
    """One GET on a fresh connection: status, headers, body."""
    from http.client import HTTPConnection
    from urllib.parse import urlparse

    u = urlparse(url)
    conn = HTTPConnection(u.hostname, u.port, timeout=120)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def _region_path(lo, hi, fmt: str, quantity: str = "p", t: int = 0) -> str:
    return (f"/v1/region/{quantity}/{t}?lo={','.join(map(str, lo))}"
            f"&hi={','.join(map(str, hi))}&format={fmt}")


def _connected(url: str, n: int) -> list:
    """``n`` clients, each with its keep-alive connection opened one after
    another (a ``/healthz``): the server's listen backlog is 5, and 16
    connects at once wait out a dropped SYN's 1 s retry (``front``)."""
    from repro_torch.serve import Client

    clients = [Client(url, timeout=120) for _ in range(n)]
    for c in clients:
        check(c.healthz(), f"serve_path: /healthz of {url}")
    return clients


def _hist_quantile(snap: dict, q: float) -> float:
    """The ``q`` quantile of a histogram snapshot, interpolated linearly
    inside its bucket (Prometheus' ``histogram_quantile``); the +Inf bucket
    gives the last finite bound."""
    total = snap["count"]
    rank, prev_le, prev_cum = q * total, 0.0, 0
    for le, cum in snap["buckets"]:
        if cum >= rank:
            if le == float("inf"):
                return prev_le
            return prev_le + (le - prev_le) * (rank - prev_cum) / max(1, cum - prev_cum)
        prev_le, prev_cum = le, cum
    return prev_le


def _lock_boxes() -> list:
    """Distinct 64^3 boxes whose chunks are distinct: box (i, j) covers the
    blocks bx = 2i, 2i+1 and by = 2j, 2j+1, so the chunks 16i + j and
    16i + 8 + j (32 blocks of 32^3 per chunk, 16 per (bx, by) pair)."""
    out = []
    for i in range(8):
        for j in range(SERVE_LOCK_BOXES // 8):
            lo = (64 * i, 64 * j, 64 * ((i + j) % 8))
            out.append((lo, tuple(v + 64 for v in lo)))
    return out


def phase_serve(tmp: str, p512, wavelet_file: str, root: str, sides: list[dict]) -> dict:
    """The region server (``repro_torch.serve``) on the card, over
    dataset_path's FileStore dataset of the 512^3 p (``root``: wavelet, the
    default spec, main_path's chunks) and one 128^3 dataset each of
    parallel_path's cube under zfpx and lorenzo (set-up: their appends'
    encode launches are checked but not counted as serving).  Every server
    runs in this process, ``device="cuda"``; each step runs with the launch
    counts set to 0 just before and read just after.

    1. Tiers (a fresh ``RegionHTTPServer``): region_path's unaligned box b
       cold (one inverse launch per covering chunk, ``/metrics``'
       ``cz_serve_chunks_decoded_total`` equal), again (a region-cache hit,
       no launch), and a box over the same chunks (chunk-cache hits, no
       launch), each body bit-equal to ``FieldReader.read_box`` of
       main_path's p on the card; the latency of each.
    2. Byte identity: box b and a full-depth 32x32x512 column over HTTP in
       ``raw`` and ``npy`` (with the ``X-CZ-Shape``/``X-CZ-Dtype``
       headers), and through ``FieldRegionServer.query``, equal to
       ``FieldReader.read_box``; likewise one box of each small dataset,
       whose cold read launches ``zfpx_decode`` or ``lorenzo_decode`` once
       per chunk.
    3. Coalescing: ``cache_chunks=1``, a ``threading.Barrier`` releases
       16 clients onto box b, cold: 16 identical bodies, the covering
       chunks decoded once each (launches equal), and coalesced chunk
       fetches plus region flights joined plus region-cache hits = 15.
    4. The decode lock: 32 distinct cold 64^3 boxes (64 distinct chunks)
       served to 1, 4 and 16 concurrent clients, a fresh server per level
       (``max_inflight=8``, the CLI's default): wall, queries per s, p50 and
       p99 from ``cz_serve_request_seconds`` and from the clients' clocks,
       ``cz_reader_decode_seconds`` summed over the wall, inverse launches
       (= chunks decoded), and the decode kernel's device time over the
       wall from a torch.profiler trace of the level.
    5. The CLI: ``python -m repro_torch.launch.compress serve ROOT --port
       0`` in a subprocess with no ``--device`` (the card is the default):
       its boot until ``/healthz`` answers, box b bit-equal, ``stats URL``
       (in-process) exits 0 and lists ``cz_serve_queries_total``, and SIGINT
       ends it with exit 0 after ``shutting down``."""
    import threading

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.core import container
    from repro_torch.core.pipeline import CompressionSpec
    from repro_torch.serve import Client, RegionHTTPServer
    from repro_torch.store import CZDataset

    counted, launched = _launch_counter("serve_path", sides)
    lo_b, hi_b = REGION_BOXES["b_unaligned"]

    steps, mark = {}, [time.perf_counter()]

    def step(name: str) -> None:
        """The wall seconds since the last step ended, under ``name``."""
        now = time.perf_counter()
        steps[name] = now - mark[0]
        mark[0] = now

    # set-up: the two small datasets (their encodes are not serving)
    cube = p512[PARALLEL_CUBE, PARALLEL_CUBE, PARALLEL_CUBE].cpu().numpy()
    roots = {"wavelet": root}
    setup = {}
    for scheme in SERVE_SCHEMES:
        roots[scheme] = os.path.join(tmp, "serve", scheme)
        _zero_launches(sides)
        t0 = time.perf_counter()
        with CZDataset(roots[scheme], "a", spec=CompressionSpec(scheme=scheme),
                       device="cuda") as ds:
            ds.append({"p": cube}, time=T_MAIN)
        setup[scheme] = {"append_s": time.perf_counter() - t0}
        got = _cuda_launches()
        check(got[f"{scheme}_encode"] == 1 and sum(got.values()) == 1,
              f"serve_path: the {scheme} append launched {got}")

    def reference(scheme: str, lo, hi):
        path = wavelet_file if scheme == "wavelet" else os.path.join(roots[scheme], "p",
                                                                     "t000000.cz")
        with container.FieldReader(path, device="cuda") as r:
            return r.read_box(lo, hi), r.box_chunks(lo, hi)

    want_b, cis_b = reference("wavelet", lo_b, hi_b)
    want_s, cis_s = reference("wavelet", *SERVE_SHIFTED)
    want_col, cis_col = reference("wavelet", *SERVE_COLUMN)
    step("setup")
    chunks_b = len(cis_b)
    check(chunks_b == 8 and cis_s == cis_b and len(cis_col) == 16
          and not set(cis_col) & set(cis_b),
          f"serve_path: chunks {cis_b}, {cis_s}, {cis_col}")

    def raw_equal(status, headers, body, want) -> bool:
        return (status == 200 and body == want.tobytes()
                and headers.get("X-CZ-Shape") == ",".join(map(str, want.shape))
                and headers.get("X-CZ-Dtype") == "float32")

    def npy_equal(status, body, want) -> bool:
        return status == 200 and np.lib.format.read_array(io.BytesIO(body)).tobytes() == \
            want.tobytes()

    # 1. tiers
    tiers = {}
    with RegionHTTPServer(root, port=0, device="cuda").start() as srv:
        for label, (lo, hi), want, launches in (
                ("cold", (lo_b, hi_b), want_b, chunks_b),
                ("region_hit", (lo_b, hi_b), want_b, 0),
                ("chunk_hit", SERVE_SHIFTED, want_s, 0)):
            before = srv.region.stats()
            res, dt, _ = counted({"wavelet3d_inverse": launches}, f"tiers {label}",
                                 lambda lo=lo, hi=hi: _http_get(srv.url,
                                                                _region_path(lo, hi, "raw")))
            check(raw_equal(*res, want), f"serve_path: the {label} box differs from read_box")
            after = srv.region.stats()
            tiers[label] = {"ms": dt * 1e3, **{k: after[k] - before[k] for k in (
                "chunks_decoded", "region_cache_hits", "cache_hits", "region_cache_misses")}}
        with Client(srv.url) as c:
            decoded = c.metric("cz_serve_chunks_decoded_total")
        check(decoded == chunks_b and tiers["cold"]["chunks_decoded"] == chunks_b
              and tiers["region_hit"]["region_cache_hits"] == 1
              and tiers["chunk_hit"]["chunks_decoded"] == 0
              and tiers["chunk_hit"]["cache_hits"] == chunks_b,
              f"serve_path: tiers {tiers}, /metrics decoded {decoded}")

        # 2. byte identity, on the same server: box b is now a region hit
        def identity():
            out = {}
            for name, (lo, hi), want in (("b_unaligned", (lo_b, hi_b), want_b),
                                         ("column", SERVE_COLUMN, want_col)):
                out[f"{name} raw"] = raw_equal(*_http_get(srv.url, _region_path(lo, hi, "raw")),
                                               want)
                st, _h, body = _http_get(srv.url, _region_path(lo, hi, "npy"))
                out[f"{name} npy"] = npy_equal(st, body, want)
                out[f"{name} query"] = srv.region.query("p", 0, lo, hi).tobytes() == \
                    want.tobytes()
            return out

        same, ident_s, _ = counted({"wavelet3d_inverse": len(cis_col)}, "identity wavelet",
                                   identity)
    for scheme in SERVE_SCHEMES:
        want, cis = reference(scheme, *SERVE_SMALL_BOX)
        chunks = len(cis)
        with RegionHTTPServer(roots[scheme], port=0, device="cuda").start() as srv:
            def small(srv=srv, want=want):
                lo, hi = SERVE_SMALL_BOX
                return {"raw": raw_equal(*_http_get(srv.url, _region_path(lo, hi, "raw")), want),
                        "npy": npy_equal(*_http_get(srv.url, _region_path(lo, hi, "npy"))[::2],
                                         want),
                        "query": srv.region.query("p", 0, lo, hi).tobytes() == want.tobytes()}

            res, dt, _ = counted({f"{scheme}_decode": chunks}, f"identity {scheme}", small)
            same.update({f"{scheme} {k}": v for k, v in res.items()})
            setup[scheme].update({"chunks": chunks, "cold_box_ms": dt * 1e3})
    check(all(same.values()), f"serve_path: bodies differ from read_box: {same}")
    step("tiers_identity")

    # 3. coalescing
    with RegionHTTPServer(root, port=0, cache_chunks=1, device="cuda").start() as srv:
        barrier = threading.Barrier(SERVE_COALESCED)
        bodies = [None] * SERVE_COALESCED
        clients = _connected(srv.url, SERVE_COALESCED)

        def fetch(i):
            with clients[i] as c:
                barrier.wait()
                bodies[i] = c.region_raw("p", 0, lo_b, hi_b).tobytes()

        def coalesce():
            threads = [threading.Thread(target=fetch, args=(i,))
                       for i in range(SERVE_COALESCED)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

        _, coal_s, _ = counted({"wavelet3d_inverse": chunks_b}, "coalescing", coalesce)
        s = srv.region.stats()
        with Client(srv.url) as c:
            coalesced = c.metric("cz_serve_coalesced_requests_total")
    check(bodies == [want_b.tobytes()] * SERVE_COALESCED,
          "serve_path: the coalesced clients' bodies differ")
    joined = coalesced + s["region_flights_joined"] + s["region_cache_hits"]
    check(s["chunks_decoded"] == chunks_b and joined == SERVE_COALESCED - 1,
          f"serve_path: coalescing decoded {s['chunks_decoded']}, joined {joined}")
    step("coalescing")
    coalescing = {"clients": SERVE_COALESCED, "s": coal_s, "chunks_decoded": s["chunks_decoded"],
                  "coalesced_requests": coalesced,
                  "region_flights_joined": s["region_flights_joined"],
                  "region_cache_hits": s["region_cache_hits"]}

    # the HTTP front itself: a small response on a keep-alive connection
    # against one on a fresh connection, and 16 connects at once
    def front():
        with RegionHTTPServer(root, port=0, device="cuda").start() as srv:
            def ms(fn, reps=5):
                times = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    fn()
                    times.append((time.perf_counter() - t0) * 1e3)
                return statistics.median(times)

            with Client(srv.url) as c:
                c.healthz()
                keepalive = ms(c.healthz)
            fresh = ms(lambda: _http_get(srv.url, "/healthz"))
            barrier, waits = threading.Barrier(SERVE_COALESCED), []

            def connect():
                barrier.wait()
                t0 = time.perf_counter()
                with Client(srv.url) as c:
                    c.healthz()
                waits.append(time.perf_counter() - t0)

            threads = [threading.Thread(target=connect) for _ in range(SERVE_COALESCED)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            return {"healthz_keepalive_ms": keepalive, "healthz_fresh_ms": fresh,
                    "connects": SERVE_COALESCED, "connect_max_s": max(waits),
                    "listen_backlog": srv.request_queue_size}

    front_line, _, _ = counted({}, "front", front)
    step("front")

    # 4. the decode lock
    boxes = _lock_boxes()
    lock, first = {}, None
    for level in SERVE_LEVELS:
        with RegionHTTPServer(root, port=0, device="cuda").start() as srv:
            lat = [[] for _ in range(level)]
            got = [[] for _ in range(level)]
            clients = _connected(srv.url, level)

            def client(k):
                with clients[k] as c:
                    for lo, hi in boxes[k::level]:
                        t0 = time.perf_counter()
                        got[k].append(c.region_raw("p", 0, lo, hi).tobytes())
                        lat[k].append(time.perf_counter() - t0)

            def run_level():
                threads = [threading.Thread(target=client, args=(k,)) for k in range(level)]
                d0 = _reader_sums()["cz_reader_decode_seconds"]
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    for t in threads:
                        t.start()
                    for t in threads:
                        t.join()
                    wall = time.perf_counter() - t0
                    torch.cuda.synchronize()
                us, seen = 0.0, 0
                for ev in prof.key_averages():
                    if "wavelet3d_cluster_kernel" in ev.key:
                        us += ev.device_time_total
                        seen += ev.count
                return wall, _reader_sums()["cz_reader_decode_seconds"] - d0, us / 1e6, seen

            (wall, decode_s, kernel_s, seen), _, n = counted(
                {"wavelet3d_inverse": 2 * len(boxes)}, f"decode lock at {level}", run_level)
            s = srv.region.stats()
            snap = srv.region.latency.snapshot()
        bodies = {box: b for k in range(level) for box, b in zip(boxes[k::level], got[k])}
        if first is None:
            first = bodies
        check(bodies == first and s["chunks_decoded"] == n == 2 * len(boxes)
              and snap["count"] == len(boxes),
              f"serve_path: decode lock at {level}: {s['chunks_decoded']} chunks, {n} launches")
        client_ms = sorted(v * 1e3 for row in lat for v in row)
        lock[f"clients{level}"] = {
            "clients": level, "queries": len(boxes), "wall_s": wall,
            "qps": len(boxes) / wall,
            "p50_ms": _hist_quantile(snap, 0.5) * 1e3, "p99_ms": _hist_quantile(snap, 0.99) * 1e3,
            "client_p50_ms": client_ms[len(client_ms) // 2], "client_max_ms": client_ms[-1],
            "decode_s": decode_s, "decode_share": decode_s / wall,
            "launches": n, "chunks_decoded": s["chunks_decoded"],
            "kernel_s": kernel_s, "kernel_share": kernel_s / wall, "profiled_launches": seen}
    lo, hi = boxes[0]
    check(first[boxes[0]] == reference("wavelet", lo, hi)[0].tobytes(),
          "serve_path: a decode-lock box differs from read_box")
    step("decode_lock")

    # 5. the CLI, in its own process
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.compress", "serve",
                             root, "--port", "0"], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    try:
        first_line = proc.stdout.readline()
        url = first_line.rsplit(" at ", 1)[-1].strip()
        check(first_line.startswith(f"serving {root} [p] at http://"),
              f"serve_path: the CLI printed {first_line!r}")
        with Client(url, timeout=120) as c:
            check(c.healthz(), "serve_path: the CLI's /healthz")
            boot_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            box = c.region_raw("p", 0, lo_b, hi_b)
            cli_box_ms = (time.perf_counter() - t1) * 1e3
            check(box.tobytes() == want_b.tobytes(), "serve_path: the CLI's box differs")
        (code, text), _, _ = counted({}, "CLI stats", lambda: cli("stats", url))
        check(code == 0 and "cz_serve_queries_total" in text,
              f"serve_path: stats {url} gave {code}")
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    check(proc.returncode == 0 and out.rstrip().endswith("shutting down"),
          f"serve_path: the CLI exited {proc.returncode}: {out[-300:]} {err[-300:]}")
    step("cli")
    shutil.rmtree(os.path.join(tmp, "serve"), ignore_errors=True)
    return {"steps_s": steps, "dataset": "dataset_path's 512^3 p (wavelet, 128 chunks) and 128^3 cubes",
            "setup": setup, "tiers": tiers, "identity_s": ident_s, "identical": same,
            "coalescing": coalescing, "front": front_line, "decode_lock": lock,
            "cli": {"boot_s": boot_s, "box_ms": cli_box_ms, "exit": proc.returncode,
                    "stats_exit": code}, **launched}


# insitu_path: the paper's Fig. 12 on one card.  The solver runs on the
# per-card subdomain of the other paths; the restart and the card-CPU
# comparison run at 128^3, where five CPU steps fit the phase's budget.
INSITU_N = N_MAIN
INSITU_BUBBLES = 8
INSITU_STEPS = 10
INSITU_EVERY = 5
INSITU_QOIS = ("p", "rho")
INSITU_WORKERS = 4
INSITU_SMALL = 128
INSITU_SMALL_STEPS = 5
# five steps on the card against the CPU: tests/test_torch_euler3d.py's
# RUN_TOL (rtol, and atol as a fraction of max |CPU|)
INSITU_SOLVER_TOL = 1e-5


def _snapshot_split(events: list[dict], qois) -> dict:
    """One snapshot's seconds by its trace spans, per QoI: the member's
    write (the field goes to stage 1 on the card, with no host copy before
    it), within it stage 1 and the chunks' encodes (first start to last
    end, across the pool's threads), and the rest of the write; and the
    manifest's commit."""
    def walls(name, lo=None, hi=None, **args):
        evs = [e for e in events if e["name"] == name
               and all(e.get("args", {}).get(k) == v for k, v in args.items())
               and (lo is None or lo <= e["ts"] <= hi)]
        check(bool(evs), f"insitu_path: no {name} {args} span in the snapshot's trace")
        return min(e["ts"] for e in evs), max(e["ts"] + e["dur"] for e in evs)

    out = {}
    for q in qois:
        w0, w1 = walls("dataset.write", quantity=q)
        s0, s1 = walls("stage1", w0, w1)
        e0, e1 = walls("encode", w0, w1)
        out[q] = {"write": (w1 - w0) / 1e6,
                  "stage1": (s1 - s0) / 1e6, "encode": (e1 - e0) / 1e6,
                  "write_rest": ((w1 - w0) - (s1 - s0) - (e1 - e0)) / 1e6}
    m0, m1 = walls("dataset.commit")
    out["commit"] = (m1 - m0) / 1e6
    return out


def phase_insitu(torch, tmp: str, sides: list[dict]) -> dict:
    """In-situ compression while the solver runs (the paper's Fig. 12), on
    the card.

    1. ``init_bubble_cloud(EulerConfig(n=512, n_bubbles=8), "cuda")`` (a
       5x512^3 float32 state, 2.5 GiB), dt from ``cfl_dt``, 10 ``step``s.
    2. A ``FieldSnapshotter(every=5, spec=CompressionSpec(), workers=4,
       device="cuda")`` takes p and rho from ``primitives`` at steps 5 and
       10: one forward launch per field snapshotted (4).
    3. The directory reopened, ``restore()`` resolves step 10, one inverse
       launch per chunk decoded (2 x 128), each field within 100 eps of the
       snapshot taken.
    4. At n = 128: a ``Checkpointer(every=5, keep=2, device="cuda")`` saves
       ``{"U": U, "step": s}`` under its default fpzipx at steps 5 and 10;
       ``resume`` gives step 10 and U bit-equal to the live state, and five
       more steps from each are bit-equal.
    5. At n = 128: p snapshotted by a ``FieldSnapshotter`` with
       ``device="cuda"`` and one with ``device="cpu"`` have the same chunk
       bytes; five steps on the card agree with five on the CPU within
       ``INSITU_SOLVER_TOL``.
    Every step runs with the launch counts set to 0 just before and read
    just after.  Prints the solver's seconds per step and peak card memory,
    each snapshot's seconds per QoI by its trace spans, CR and max error per
    QoI, the restore's seconds and the in-situ overhead ``io_s / (sim_s +
    io_s)`` (``benchmarks/bench_insitu.py``): ``sim_s`` the 10 steps,
    ``io_s`` the two ``maybe_snapshot`` calls, stage 1's copies included."""
    import math

    from repro_torch.ckpt import Checkpointer, FieldSnapshotter, latest_step
    from repro_torch.core import container
    from repro_torch.core.pipeline import CompressionSpec
    from repro_torch.fields import euler3d
    from repro_torch.obs import trace
    from repro_torch.store import FileStore

    counted, launched = _launch_counter("insitu_path", sides)
    base = os.path.join(tmp, "insitu")
    marks, t_phase = {}, time.perf_counter()

    def mark(name: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        marks[name] = now - t_phase
        t_phase = now

    cfg = euler3d.EulerConfig(n=INSITU_N, n_bubbles=INSITU_BUBBLES)
    U, init_s, _ = counted({}, "init_bubble_cloud",
                           lambda: euler3d.init_bubble_cloud(cfg, device="cuda"))
    check(U.shape == (5, INSITU_N, INSITU_N, INSITU_N) and U.device.type == "cuda",
          f"insitu_path: state {tuple(U.shape)} on {U.device}")
    dt = euler3d.cfl_dt(U)
    root = os.path.join(base, "snapshots")
    snap = FieldSnapshotter(root, every=INSITU_EVERY, spec=CompressionSpec(),
                            workers=INSITU_WORKERS, device="cuda")
    step_s, snapshots = [], []
    mark("init")

    def simulate():
        nonlocal U
        taken = {}
        for s in range(1, INSITU_STEPS + 1):
            t0 = time.perf_counter()
            U = euler3d.step(U, dt)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            if s % INSITU_EVERY:
                continue
            t0 = time.perf_counter()
            rho, _vel, p = euler3d.primitives(U)
            fields = {"p": p, "rho": rho}
            torch.cuda.synchronize()
            prim_s = time.perf_counter() - t0
            trace.reset()
            trace.enable()
            t0 = time.perf_counter()
            t = snap.maybe_snapshot(fields, s)
            io_s = time.perf_counter() - t0
            trace.disable()
            split = _snapshot_split(trace.TRACER.events(), INSITU_QOIS)
            trace.reset()
            check(t == len(snapshots), f"insitu_path: step {s} snapshotted as timestep {t}")
            taken = {q: fields[q].clone() for q in INSITU_QOIS}
            snapshots.append({"step": s, "t": t, "seconds": io_s, "primitives_s": prim_s,
                              "by_span": split})
        return taken

    torch.cuda.reset_peak_memory_stats()
    nqoi = len(INSITU_QOIS)
    taken, loop_s, _ = counted({"wavelet3d_forward": nqoi * INSITU_STEPS // INSITU_EVERY},
                               "solver with snapshots", simulate)
    peak = torch.cuda.max_memory_allocated()
    for rec in snapshots:
        for q in INSITU_QOIS:
            info = snap.ds.timestep_info(q, rec["t"])
            rec["by_span"][q]["cr"] = info["raw_bytes"] / info["bytes"]
    snap.close()
    mark("solver_and_snapshots")

    nchunks = math.ceil((INSITU_N // 32) ** 3 / 32)
    again = FieldSnapshotter(root, every=INSITU_EVERY, device="cuda")
    (fields, rstep), restore_s, _ = counted({"wavelet3d_inverse": nqoi * nchunks}, "restore",
                                            again.restore)
    again.close()
    check(rstep == INSITU_STEPS and sorted(fields) == sorted(INSITU_QOIS),
          f"insitu_path: restore gave step {rstep}, {sorted(fields)}")
    max_err = {}
    for q in INSITU_QOIS:
        got = torch.from_numpy(fields[q]).to("cuda")
        max_err[q] = (got.double() - taken[q].double()).abs().max().item()
        check(max_err[q] <= 100 * EPS, f"insitu_path: restored {q} max error {max_err[q]}")
    del U, taken, fields
    mark("restore")

    small = euler3d.init_bubble_cloud(
        euler3d.EulerConfig(n=INSITU_SMALL, n_bubbles=INSITU_BUBBLES), device="cuda")
    dts = euler3d.cfl_dt(small)
    ckdir = os.path.join(base, "ckpt")
    ck = Checkpointer(ckdir, every=INSITU_EVERY, keep=2, device="cuda")
    saves = {}

    def checkpointed():
        Us = small
        for s in range(1, INSITU_STEPS + 1):
            Us = euler3d.step(Us, dts)
            m = ck.maybe_save({"U": Us, "step": s}, s)
            if m is not None:
                saves[s] = m["cr"]
        return Us

    live, ckpt_run_s, _ = counted({}, "checkpointed run at n=128", checkpointed)
    check(sorted(saves) == [INSITU_EVERY, INSITU_STEPS] and latest_step(ckdir) == INSITU_STEPS,
          f"insitu_path: checkpoints {sorted(saves)}, latest {latest_step(ckdir)}")
    template = {"U": torch.zeros(1, device="cuda"), "step": 0}
    (state, rs), resume_s, _ = counted({}, "resume", lambda: ck.resume(template))
    check(rs == INSITU_STEPS and int(state["step"]) == INSITU_STEPS,
          f"insitu_path: resumed step {rs}, state step {int(state['step'])}")
    check(state["U"].device.type == "cuda"
          and torch.equal(state["U"].view(torch.int32), live.view(torch.int32)),
          "insitu_path: the resumed U is not the live U bit for bit")
    cont = euler3d.run(state["U"], INSITU_SMALL_STEPS, dt=dts)
    ref = euler3d.run(live, INSITU_SMALL_STEPS, dt=dts)
    check(torch.equal(cont.view(torch.int32), ref.view(torch.int32)),
          "insitu_path: five steps after the resume differ from five after the live U")
    mark("restart")

    p_small = euler3d.primitives(live)[2]
    chunks = {}
    for dev, want in (("cuda", {"wavelet3d_forward": 1}), ("cpu", {})):
        d = os.path.join(base, f"snap_{dev}")
        sn = FieldSnapshotter(d, spec=CompressionSpec(), device=dev)
        field = p_small if dev == "cuda" else p_small.cpu()
        counted(want, f"snapshot at n=128 on {dev}", lambda: sn.maybe_snapshot({"p": field}, 0))
        sn.close()
        chunks[dev] = [c for c, _n in container.iter_compressed("p/t000000.cz",
                                                                store=FileStore(d))]
    check(chunks["cuda"] == chunks["cpu"],
          "insitu_path: the card's wavelet snapshot has other chunk bytes than the CPU's")
    host = live.cpu()
    t0 = time.perf_counter()
    on_cpu = euler3d.run(host, INSITU_SMALL_STEPS, dt=dts)
    cpu_steps_s = time.perf_counter() - t0
    on_card = ref.cpu()
    diff = (on_card.double() - on_cpu.double()).abs()
    scale = on_cpu.abs().max().item()
    ok = bool((diff <= INSITU_SOLVER_TOL * scale
               + INSITU_SOLVER_TOL * on_cpu.double().abs()).all())
    check(ok, f"insitu_path: card vs CPU after {INSITU_SMALL_STEPS} steps: "
              f"max |diff| {diff.max().item()} (scale {scale})")
    mark("card_vs_cpu")
    shutil.rmtree(base, ignore_errors=True)

    sim_s = sum(step_s)
    io_s = sum(r["seconds"] for r in snapshots)
    return {"n": INSITU_N, "n_bubbles": INSITU_BUBBLES, "steps": INSITU_STEPS,
            "every": INSITU_EVERY, "qois": list(INSITU_QOIS), "workers": INSITU_WORKERS,
            "spec": "CompressionSpec() defaults (w3ai, eps 1e-3, 32^3 blocks)", "dt": dt,
            "init_s": init_s, "step_s": step_s, "sim_s": sim_s,
            "peak_mem_bytes": peak, "loop_s": loop_s, "snapshots": snapshots,
            "io_s": io_s, "overhead": io_s / (sim_s + io_s),
            "restore_s": restore_s, "restore_chunks": nqoi * nchunks, "max_err": max_err,
            "restart": {"n": INSITU_SMALL, "run_s": ckpt_run_s, "cr": saves,
                        "resume_s": resume_s, "bit_equal": True, "after_bit_equal": True},
            "card_vs_cpu": {"n": INSITU_SMALL, "snapshot_chunks_equal": True,
                            "chunks": len(chunks["cpu"]), "steps": INSITU_SMALL_STEPS,
                            "max_abs_diff": diff.max().item(),
                            "bit_equal": bool((diff == 0).all()), "tol": INSITU_SOLVER_TOL,
                            "cpu_steps_s": cpu_steps_s},
            "stages_s": marks, **launched}


# llm_path: the LLM serve path at smollm-135m's full width.  The CLI run is
# the reference driver's (B 4, prompt 16, 32 new tokens, float32); the
# prefill is prefill_32k's settings cut to B = 4, S = 4096 (32 x 32768 does
# not fit the phase's 15 s); every reduced config runs card against CPU.
LLM_ARCH = "smollm-135m"
LLM_CLI = ("--arch", LLM_ARCH, "--batch", "4", "--prompt-len", "16", "--max-new", "32")
LLM_PREFILL_B, LLM_PREFILL_S = 4, 4096
LLM_GRAPH_REPLAYS = 20
# card against CPU, float32 on both (TF32 off): the port's CPU tolerance
# against the reference (tests/test_torch_models.py), the scale max |CPU|
LLM_RTOL, LLM_ATOL_SCALE = 1e-4, 1e-5
LLM_SMALL_B, LLM_SMALL_S, LLM_DECODE_STEPS = 2, 16, 4
# bf16 prefill against float32, as a share of the largest |float32 logit|.
# bf16 keeps an 8-bit significand (unit roundoff u = 2^-8); the reduced
# configs' bf16 logits lie within 4u of their float32 ones at 2 layers
# (tests/test_torch_models.py); independent roundings grow like the root
# of depth, so 30 layers give ~4u x sqrt(15) ~ 16u, and the bound is twice
# that: 32u = 2^-3.
LLM_BF16_REL = 2.0 ** -3
LLM_F32_PREFILL_CHUNKS = (1024, 4096)


def _llm_close(got, want) -> tuple[bool, float, float]:
    """(within LLM_RTOL and LLM_ATOL_SCALE * max|want|, max |diff|, scale)"""
    import torch

    got = got.detach().cpu()
    scale = want.abs().max().item()
    ok = torch.allclose(got, want, rtol=LLM_RTOL, atol=LLM_ATOL_SCALE * scale)
    return ok, (got - want).abs().max().item(), scale


def _llm_run(torch, cfg, params, toks, frames, xkv, dev: str) -> tuple:
    """(prefill logits, LLM_DECODE_STEPS decode logits, the cache after) of
    one reduced config on ``dev``."""
    from repro_torch.models import ModelSettings, cache_spec, decode_step, prefill

    st = ModelSettings(q_chunk=8, kv_chunk=8, remat="none", compute_dtype=torch.float32)
    logits = prefill(params, toks.to(dev), cfg, st,
                     enc_inputs=None if frames is None else frames.to(dev))
    cache = cache_spec(cfg, toks.shape[0], toks.shape[1], dtype=torch.float32,
                       mode="zeros", device=dev)
    for k, v in xkv.items():   # encoder KV, as a prefill would leave it
        cache[k].copy_(v)
    steps = []
    for i in range(LLM_DECODE_STEPS):
        lg, cache = decode_step(params, cache, toks[:, i:i + 1].to(dev), i, cfg, st)
        steps.append(lg)
    return logits, steps, cache


def _llm_card_vs_cpu(torch) -> dict:
    """Each reduced config's prefill logits, and four decode steps' logits
    and caches, on the card and on the CPU from the same weights; per
    config the largest |card - CPU| over max |CPU| of each."""
    import numpy as np

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import init_params
    from repro_torch.models.common import tree_map

    rows = {}
    for name in sorted(ARCHS):
        cfg = reduced(ARCHS[name])
        rng = np.random.default_rng(0)
        B, S = LLM_SMALL_B, LLM_SMALL_S
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
        frames, xkv = None, {}
        if cfg.family == "encdec":
            frames = torch.from_numpy(rng.standard_normal((B, cfg.enc_frames, cfg.d_model))
                                      .astype(np.float32))
            shape = (cfg.n_layers, B, cfg.enc_frames, cfg.n_kv_heads, cfg.hd)
            xkv = {k: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                   for k in ("xk", "xv")}
        cpu_params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        card_params = tree_map(lambda a: a.to("cuda"), cpu_params)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)   # tiny ops: a thread pool costs 10-100x here
        try:
            want = _llm_run(torch, cfg, cpu_params, toks, frames, xkv, "cpu")
        finally:
            torch.set_num_threads(threads)
        got = _llm_run(torch, cfg, card_params, toks, frames, xkv, "cuda")
        pairs = [("prefill", got[0], want[0])]
        pairs += [(f"decode {i}", a, b) for i, (a, b) in enumerate(zip(got[1], want[1]))]
        pairs += [(f"cache {k}", got[2][k], want[2][k]) for k in want[2]]
        worst = {"prefill": 0.0, "decode": 0.0, "cache": 0.0}
        for what, a, b in pairs:
            check(a.device.type == "cuda", f"llm_path: {name} {what} on {a.device}")
            ok, diff, scale = _llm_close(a, b)
            check(ok, f"llm_path: {name} {what}: card vs CPU max |diff| {diff} at scale "
                      f"{scale}")
            kind = what.split()[0]
            worst[kind] = max(worst[kind], diff / max(scale, 1e-30))
        rows[name] = worst
    return rows


def _llm_full_vs_cpu(torch, params, cfg, prompt, gen) -> dict:
    """The CLI run's last LLM_DECODE_STEPS positions teacher-forced again on
    the card and on the CPU, each from a copy of the run's cache: every
    step's logits, the cache after, and the CLI's last logits against the
    CPU's.  Positions past those written are masked, so the cache after the
    whole run serves as the cache before them."""
    from repro_torch.launch import serve as lserve
    from repro_torch.models.common import tree_leaves, tree_map

    seq = torch.cat([prompt, gen.tokens.cpu()], dim=1)   # the token fed at each position
    n = seq.shape[1]
    runs = {}
    for dev, p in (("cuda", params), ("cpu", tree_map(lambda a: a.cpu(), params))):
        cache = tree_map(lambda a: a.to(dev, copy=True), gen.cache)
        steps = []
        for pos in range(n - LLM_DECODE_STEPS, n):
            lg, cache = lserve.decode_step(p, cache, seq[:, pos:pos + 1].to(dev), pos, cfg,
                                           lserve.SETTINGS)
            steps.append(lg)
        runs[dev] = steps, cache
    (card, card_cache), (cpu, cpu_cache) = runs["cuda"], runs["cpu"]
    pairs = [(f"step {n - LLM_DECODE_STEPS + i}", a, b) for i, (a, b) in enumerate(zip(card, cpu))]
    pairs.append(("the CLI's last logits", gen.logits, cpu[-1]))
    pairs += [(f"cache {'/'.join(k)}", a, dict(tree_leaves(cpu_cache))[k])
              for k, a in tree_leaves(card_cache)]
    pairs += [(f"the CLI's cache {'/'.join(k)}", a, dict(tree_leaves(cpu_cache))[k])
              for k, a in tree_leaves(gen.cache)]
    worst = {"logits": 0.0, "cache": 0.0}
    for what, a, b in pairs:
        check(a.device.type == "cuda", f"llm_path: full width {what} on {a.device}")
        ok, diff, scale = _llm_close(a, b)
        check(ok, f"llm_path: full width {what}: card vs CPU max |diff| {diff} at scale {scale}")
        kind = "cache" if "cache" in what else "logits"
        worst[kind] = max(worst[kind], diff / max(scale, 1e-30))
    return {"positions": [n - LLM_DECODE_STEPS, n - 1], "max_rel_diff": worst}


def phase_llm(torch, sides: list[dict]) -> dict:
    """The LLM serve path on the card: the CLI at full width, a bf16
    prefill, and the reduced configs card against CPU."""
    import numpy as np

    from repro_torch.launch import serve as lserve
    from repro_torch.models import ModelSettings, prefill
    from repro_torch.models.common import tree_leaves
    from repro_torch.serve.step import build_decode_step

    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "llm_path: TF32 matmuls are on; the float32 comparisons need them off")
    counted, launched = _launch_counter("llm_path", sides)
    marks, t_mark = {}, time.perf_counter()

    def mark(name: str) -> None:
        nonlocal t_mark
        now = time.perf_counter()
        marks[name] = now - t_mark
        t_mark = now

    seen = {}
    generate = lserve.generate

    def recording(params, cfg, prompt, max_new):
        seen["params"], seen["cfg"] = params, cfg
        seen["gen"] = generate(params, cfg, prompt, max_new)
        return seen["gen"]

    torch.cuda.reset_peak_memory_stats()
    lserve.generate = recording
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            toks, cli_s, _ = counted({}, "the CLI", lambda: lserve.main(list(LLM_CLI)))
    finally:
        lserve.generate = generate
    peak = torch.cuda.max_memory_allocated()
    lines = out.getvalue().splitlines()
    mark("cli")
    params, cfg, gen = seen["params"], seen["cfg"], seen["gen"]
    B, P, new = 4, 16, 32
    check(toks.shape == (B, new) and ((toks >= 0) & (toks < cfg.vocab)).all(),
          f"llm_path: tokens {toks.shape}")
    check(cfg.d_model == 576 and cfg.n_layers == 30 and cfg.vocab == 49152,
          f"llm_path: not smollm-135m's full width: {cfg}")
    check(bool(torch.isfinite(gen.logits).all()), "llm_path: non-finite logits")
    param_leaves = [a for _, a in tree_leaves(params)]
    cache_leaves = [a for _, a in tree_leaves(gen.cache)]
    check(all(a.device.type == "cuda" for a in param_leaves),
          "llm_path: parameters not on the card")
    check(all(a.device.type == "cuda" for a in cache_leaves), "llm_path: cache not on the card")
    check(len(lines) == 2 and lines[0].startswith(f"decoded ({B}, {new}) in ")
          and lines[1] == f"sample: {toks[0][:16].tolist()}", f"llm_path: CLI printed {lines}")
    n_params = sum(a.numel() for a in param_leaves)
    param_bytes = sum(a.numel() * a.element_size() for a in param_leaves)
    cache_bytes = sum(a.numel() * a.element_size() for a in cache_leaves)
    # a step reads every weight once (the tied embedding as the head) and
    # the whole KV cache (every position is scored, the mask applied after)
    bound_ms = (param_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
    steps = P + new   # the prompt is stepped through the decoder too
    cli_ms = gen.seconds / steps * 1e3
    # warm: the same generation again
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (B, P))
                              .astype(np.int32))
    with torch.inference_mode():
        warm = lserve.generate(params, cfg, prompt, new)
        check(torch.equal(warm.tokens.cpu(), torch.from_numpy(toks)),
              "llm_path: a second generation from the same prompt gave other tokens")
        torch.cuda.synchronize()
        mark("warm")
        # the same step's device work without the host between kernels: one
        # decode step (the serve builder's jit_for on a 1x1 mesh) captured
        # in a CUDA graph, replayed back to back
        cache, tok, pos = warm.cache, warm.tokens[:, -1:], P + new - 1
        _, decode_for = build_decode_step(cfg, _mesh11(torch, "cuda"), settings=lserve.SETTINGS)
        decode = decode_for(params, cache, tok)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                decode(params, cache, tok, pos)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            glogits, _ = decode(params, cache, tok, pos)
        graph_ms = median_ms(graph.replay, LLM_GRAPH_REPLAYS)
        eager_logits, _ = lserve.decode_step(params, cache, tok, pos, cfg, lserve.SETTINGS)
        graph.replay()
        torch.cuda.synchronize()
        graph_ok, graph_diff, _ = _llm_close(glogits, eager_logits.cpu())
        check(graph_ok, f"llm_path: the graph's step is {graph_diff} off the eager step")
    warm_ms = warm.seconds / steps * 1e3
    busy = graph_ms / warm_ms
    mark("graph")
    with torch.inference_mode():
        full = _llm_full_vs_cpu(torch, params, cfg, prompt, gen)
    mark("full_vs_cpu")

    # prefill: the reference's default settings (bf16, masked, q 256, kv 512)
    st = ModelSettings()
    ptoks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (LLM_PREFILL_B, LLM_PREFILL_S)).astype(np.int32)).cuda()
    torch.cuda.reset_peak_memory_stats()

    def run():
        logits = prefill(params, ptoks, cfg, st)
        torch.cuda.synchronize()
        return logits

    with torch.inference_mode():
        logits, prefill_s, _ = counted({}, "prefill", run)
    prefill_peak = torch.cuda.max_memory_allocated()
    check(logits.shape == (LLM_PREFILL_B, cfg.vocab) and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()), "llm_path: prefill logits")
    prefill_tok_s = LLM_PREFILL_B * LLM_PREFILL_S / prefill_s
    mark("prefill")
    # the same weights and tokens in float32 (TF32 off, asserted above)
    qc, kc = LLM_F32_PREFILL_CHUNKS
    st32 = ModelSettings(q_chunk=qc, kv_chunk=kc, compute_dtype=torch.float32)
    with torch.inference_mode():
        ref32 = prefill(params, ptoks, cfg, st32)
    err = (logits - ref32).abs()
    scale32 = ref32.abs().max().item()
    bf16_vs_f32 = {"max_abs": err.max().item(), "scale": scale32,
                   "max_rel": err.max().item() / scale32,
                   "rel_l2": (torch.linalg.vector_norm(logits - ref32)
                              / torch.linalg.vector_norm(ref32)).item(),
                   "argmax_agree": (logits.argmax(-1) == ref32.argmax(-1)).float().mean().item(),
                   "bound_rel": LLM_BF16_REL, "f32_chunks": [qc, kc],
                   "bf16_reduced_precision_reduction":
                       torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}
    check(bool(torch.isfinite(ref32).all()) and err.max().item() <= LLM_BF16_REL * scale32,
          f"llm_path: bf16 prefill {bf16_vs_f32['max_abs']} off the float32 one at scale "
          f"{scale32} (bound {LLM_BF16_REL} of it)")
    del ref32, err
    mark("prefill_f32")

    t0 = time.perf_counter()
    with torch.inference_mode():
        small = _llm_card_vs_cpu(torch)
    small_s = time.perf_counter() - t0
    mark("card_vs_cpu")
    return {"arch": LLM_ARCH, "cli": list(LLM_CLI), "cli_s": cli_s, "cli_lines": lines,
            "n_params": n_params, "param_bytes": param_bytes, "cache_bytes": cache_bytes,
            "peak_mem_bytes": peak,
            "ms_per_step": {"cli": cli_ms, "warm": warm_ms},
            "tokens_per_s": {"cli_incl_prefill": B * steps / gen.seconds,
                             "warm_decode": B / (warm_ms / 1e3)},
            "bound_ms_per_step": bound_ms, "bound_by": "bytes",
            "graph_ms_per_step": graph_ms, "graph_vs_eager_max_abs": graph_diff,
            "device_busy_share": busy,
            "prefill": {"batch": LLM_PREFILL_B, "seq": LLM_PREFILL_S,
                        "settings": "ModelSettings() defaults: bf16, masked, q 256, kv 512",
                        "seconds": prefill_s, "tokens_per_s": prefill_tok_s,
                        "peak_mem_bytes": prefill_peak,
                        "reduced": "prefill_32k's B 32 x S 32768 cut to 4 x 4096",
                        "vs_f32": bf16_vs_f32},
            "full_width_vs_cpu": {"rtol": LLM_RTOL, "atol": f"{LLM_ATOL_SCALE} x max|cpu|",
                                  **full},
            "card_vs_cpu": {"rtol": LLM_RTOL, "atol": f"{LLM_ATOL_SCALE} x max|cpu|",
                            "batch": LLM_SMALL_B, "seq": LLM_SMALL_S,
                            "decode_steps": LLM_DECODE_STEPS, "max_rel_diff": small,
                            "seconds": small_s},
            "stages_s": marks, **launched}


# train_path: training on one card.  The CLI run is the reference driver's
# (B 8, S 64, float32, no remat) at smollm-135m's full width, 12 steps, its
# first step held against the same step on the CPU; then smollm-135m trains
# at train_4k's sequence length with ModelSettings' defaults; the ten reduced
# configs take one step on the card and on the CPU; the reduced smollm is
# killed at step 6 and resumed from its step-5 checkpoint.
TRAIN_ARCH = "smollm-135m"
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_COLD = 8, 64, 12, 2   # the first 2 steps warm up
TRAIN_CLI = ("--arch", TRAIN_ARCH, "--batch", str(TRAIN_B), "--seq", str(TRAIN_S),
             "--steps", str(TRAIN_STEPS), "--log-every", "4")
TRAIN_KILL = ("--arch", TRAIN_ARCH, "--reduced", "--steps", "12", "--batch", "2", "--seq",
              "32", "--ckpt-every", "5", "--log-every", "4")
# train_4k (S 4096, B 256; configs/base.py) cut to B 4, one step to warm up
# and one timed (a step is host-bound, ~6-9 s at any B from 1 to 4, and the
# script is at its 600 s budget): ModelSettings() defaults (masked, q 256 / kv 512, ce 1024,
# remat "full", bf16 compute; params, m and v float32)
TRAIN_LONG_B, TRAIN_LONG_S, TRAIN_LONG_COLD, TRAIN_LONG_STEPS = 4, 4096, 1, 1
BF16_FLOPS_PER_S = 989e12   # H100 SXM bf16 dense, tensor cores
# the reduced configs' step: S 32 in chunks of q 8 / kv 16 (4 x 2 blocks,
# the diagonal ones part masked), so the flash backward sums dk and dv over
# q chunks and dq over kv chunks
TRAIN_SMALL_S, TRAIN_SMALL_Q, TRAIN_SMALL_KV, TRAIN_SMALL_CE = 32, 8, 16, 16
# one step card against CPU, float32 (TF32 off), each against its scale (its
# largest |CPU value|): loss and grad_norm rtol 1e-5; m = (1 - b1) g within
# 1e-4 of the scale (tests/_torch_train.py's grad tolerance); each new
# parameter within lr min(2, 2e-4 max|m| / (|m| + (1 - b1) eps)) + 1e-6 of
# the scale: Adam's first update is lr r with r = g / (|g| + eps) in
# (-1, 1), and |dr| <= |dg| / (|g| + eps), so a grad that may move by 1e-4
# of its scale moves r by at most that over |g| + eps, and by 2 at most
# (tests/test_torch_train_step.py)
TRAIN_RTOL, TRAIN_M_SCALE, TRAIN_P_SCALE = 1e-5, 1e-4, 1e-6
# the resumed run's losses against an uninterrupted card run: the embedding's
# backward sums with atomics on CUDA, so not bit for bit
TRAIN_RESUME_RTOL = 1e-5
# mesh_path: the pod mesh's axes, the compression, K steps of each kind in
# (a), the steps of the two pods in (b), and (b)'s step-1 loss against (a)'s
# dense one (the mean of two half-batch means against the batch's mean)
MESH_AXES = ("pod", "data", "model")
MESH_METHOD, MESH_RATIO = "topk32", 32
MESH_STEPS, MESH_POD_STEPS = 3, 2
MESH_LOSS_RTOL = 1e-6


def _mesh11(torch, device: str):
    """A 1x1 ("data", "model") mesh on ``device``, as the train CLI's."""
    from repro_torch.launch.mesh import make_mesh

    return make_mesh((1, 1), ("data", "model"), device=device)


def _check_step(name: str, opt, got, gmet, want, wmet) -> dict:
    """Checks one train step's card result (``got``, ``gmet``) against the
    CPU's (``want``, ``wmet``) from the same state and batch, at the
    tolerances above; the largest |card - CPU| of the loss, grad_norm, m and
    the params, each over its scale."""
    from repro_torch.models.common import tree_leaves

    lr = wmet["lr"].item()
    worst = {}
    for k in ("loss", "grad_norm"):
        a, b = gmet[k].item(), wmet[k].item()
        check(gmet[k].device.type == "cuda" and abs(a - b) <= TRAIN_RTOL * abs(b),
              f"train_path: {name} {k} card {a} CPU {b}")
        worst[k] = abs(a - b) / abs(b)
    g_cpu = dict(tree_leaves(want["m"]))       # (1 - b1) g (got may be a host copy)
    p_card, p_cpu = dict(tree_leaves(got["params"])), dict(tree_leaves(want["params"]))
    worst["m"] = worst["params"] = 0.0
    for path, m in tree_leaves(got["m"]):
        what = f"train_path: {name} {'/'.join(path)}"
        gm = g_cpu[path]
        scale = gm.abs().max().item()
        dm = (m.cpu() - gm).abs().max().item()
        check(dm <= TRAIN_M_SCALE * scale, f"{what}: m card vs CPU {dm} at scale {scale}")
        worst["m"] = max(worst["m"], dm / max(scale, 1e-30))
        p, wp = p_card[path].cpu(), p_cpu[path]
        pscale = wp.abs().max().item()
        diff = (p - wp).abs()
        moved = (2 * TRAIN_M_SCALE * scale / (gm.abs() + (1 - opt.b1) * opt.eps)).clamp(max=2)
        check(bool((diff <= lr * moved + TRAIN_P_SCALE * pscale).all()),
              f"{what}: params card vs CPU {diff.max().item()} (lr {lr}, scale {pscale})")
        worst["params"] = max(worst["params"], diff.max().item() / max(pscale, 1e-30))
    return worst


def _train_card_vs_cpu(torch) -> dict:
    """One train step of each reduced config on the card and on the CPU from
    the same state and batch; per config the largest |card - CPU| of the
    loss, grad_norm, m and the params, each over its scale."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.data.tokens import DataConfig, batch_at
    from repro_torch.models import ModelSettings
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import build_train_step, init_train_state

    st = ModelSettings(q_chunk=TRAIN_SMALL_Q, kv_chunk=TRAIN_SMALL_KV,
                       ce_chunk=TRAIN_SMALL_CE, remat="none", compute_dtype=torch.float32)
    opt = OptConfig(lr=1e-3, warmup_steps=20, total_steps=100)
    rows = {}
    for name in sorted(ARCHS):
        cfg = reduced(ARCHS[name])
        state = init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in batch_at(
            DataConfig(vocab=cfg.vocab, batch=2, seq=TRAIN_SMALL_S, seed=1), 0).items()}
        if cfg.family == "encdec":
            batch["frames"] = torch.randn((2, cfg.enc_frames, cfg.d_model),
                                          generator=torch.Generator().manual_seed(2))
        card_state = tree_map(lambda a: a.to("cuda"), state)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)   # tiny ops: a thread pool costs 10-100x here
        try:
            want, wmet = build_train_step(cfg, _mesh11(torch, "cpu"), settings=st,
                                          opt=opt)[0](state, batch)
        finally:
            torch.set_num_threads(threads)
        got, gmet = build_train_step(cfg, _mesh11(torch, "cuda"), settings=st,
                                     opt=opt)[0](card_state, batch)
        check(all(a.device.type == "cuda" for _, a in tree_leaves(got)),
              f"train_path: {name} state not on the card")
        rows[name] = _check_step(name, opt, got, gmet, want, wmet)
    return rows


def _train_long(torch) -> dict:
    """smollm-135m at full width and S 4096 with ModelSettings() defaults:
    synchronized steps, tokens/s over the timed ones, peak memory and the
    step's bounds."""
    import math

    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.data.tokens import DataConfig, batch_at
    from repro_torch.models import ModelSettings, costs
    from repro_torch.models.common import tree_leaves
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import build_train_step, init_train_state

    cfg, st = ARCHS[TRAIN_ARCH], ModelSettings()
    opt = OptConfig(lr=1e-3, warmup_steps=20, total_steps=100)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0),
                             device="cuda")
    step = build_train_step(cfg, _mesh11(torch, "cuda"), settings=st, opt=opt)[0]
    data = DataConfig(vocab=cfg.vocab, batch=TRAIN_LONG_B, seq=TRAIN_LONG_S, seed=0)
    ms, losses = [], []
    for i in range(TRAIN_LONG_COLD + TRAIN_LONG_STEPS):
        batch = {k: torch.from_numpy(v) for k, v in batch_at(data, i).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses), f"train_path: S 4096 losses {losses}")
    leaves = list(tree_leaves(state))
    check(all(a.device.type == "cuda" for _, a in leaves)
          and all(a.dtype == torch.float32 for p, a in leaves if p[0] != "step"),
          "train_path: S 4096 state not float32 on the card")
    n_params = sum(a.numel() for _, a in tree_leaves(state["params"]))
    del state
    timed = ms[TRAIN_LONG_COLD:]
    tokens = TRAIN_LONG_B * TRAIN_LONG_S
    shape = ShapeConfig("train_4k_cut", TRAIN_LONG_S, TRAIN_LONG_B, "train")
    # the work a step needs: 6 N tokens and the causal half of the score
    # products, forward and backward, without remat's recompute
    flops = costs.detailed_flops(cfg, shape, attn_impl="triangular", remat="none")["total"]
    flops_ms = flops / BF16_FLOPS_PER_S * 1e3
    adamw_bytes = 7 * 4 * n_params
    bytes_ms = adamw_bytes / HBM_BYTES_PER_S * 1e3
    return {"batch": TRAIN_LONG_B, "seq": TRAIN_LONG_S,
            "reduced": "train_4k's B 256 x S 4096 cut to B 4",
            "settings": "ModelSettings() defaults: masked, q 256, kv 512, ce 1024, "
                        "remat full, bf16 compute, float32 params/m/v",
            "losses": losses, "ms_per_step": ms,
            "tokens_per_s": tokens * len(timed) / (sum(timed) / 1e3),
            "peak_mem_bytes": peak, "bound_ms_per_step": max(flops_ms, bytes_ms),
            "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
            "flops": flops, "flops_ms": flops_ms, "adamw_bytes": adamw_bytes,
            "bytes_ms": bytes_ms}


def phase_train(torch, sides: list[dict]) -> dict:
    """Training on the card: the CLI at full width (its first step against
    the CPU's), S 4096 at full width, the reduced configs card against CPU,
    and a kill and resume through the CLI."""
    import math

    from repro_torch.ckpt import latest_step
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import train as ltrain
    from repro_torch.models import costs
    from repro_torch.models.common import tree_leaves, tree_map

    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "train_path: TF32 matmuls are on; the float32 comparisons need them off")
    counted, launched = _launch_counter("train_path", sides)
    marks, t_mark = {}, time.perf_counter()

    def mark(name: str) -> None:
        nonlocal t_mark
        now = time.perf_counter()
        marks[name] = now - t_mark
        t_mark = now

    seen = {"ms": [], "losses": [], "cfg": None, "capture": False, "first": None}
    build = ltrain.build_train_step

    def timed_build(cfg, mesh, **kw):
        """The driver's builder, its ``jit_for`` step's calls each
        synchronized and timed; with ``seen["capture"]`` its first call's
        state and batch before, and its state and metrics after, kept on
        the host (``seen["first"]``)."""
        train_fn, jit_for, state_sh = build(cfg, mesh, **kw)
        check(tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda",
              f"train_path: the CLI's mesh is {mesh}")
        seen["cfg"], seen["kw"] = cfg, kw

        def timed_for(batch_specs):
            step = jit_for(batch_specs)

            def timed(state, batch):
                keep = seen["capture"] and seen["first"] is None
                if keep:
                    before = (tree_map(lambda a: a.cpu(), state), dict(batch))
                t0 = time.perf_counter()
                out = step(state, batch)
                torch.cuda.synchronize()
                seen["ms"].append((time.perf_counter() - t0) * 1e3)
                seen["state"], metrics = out
                seen["losses"].append(metrics["loss"].item())
                if keep:   # before the next step writes over the donated state
                    seen["first"] = (*before, tree_map(lambda a: a.cpu(), out[0]), metrics)
                return out
            return timed
        return train_fn, timed_for, state_sh

    def run_main(argv):
        """``ltrain.main(argv)`` with its steps timed (``seen``), its signal
        handlers put back after and its lines captured: (its value or its
        SystemExit code, lines)."""
        kept = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
        seen["ms"], seen["losses"] = [], []
        out = io.StringIO()
        ltrain.build_train_step = timed_build
        try:
            with contextlib.redirect_stdout(out):
                value = ltrain.main(list(argv))
        except SystemExit as e:
            value = e.code
        finally:
            ltrain.build_train_step = build
            for s, h in kept.items():
                signal.signal(s, h)
        return value, out.getvalue().splitlines()

    torch.cuda.reset_peak_memory_stats()
    seen["capture"] = True
    (value, lines), cli_s, _ = counted({}, "the CLI", lambda: run_main(TRAIN_CLI))
    seen["capture"] = False
    peak = torch.cuda.max_memory_allocated()
    mark("cli")
    cfg, state, cli_losses, cli_ms = seen["cfg"], seen["state"], seen["losses"], seen["ms"]
    check(cfg.d_model == 576 and cfg.n_layers == 30 and cfg.vocab == 49152,
          f"train_path: not smollm-135m's full width: {cfg}")
    check(len(cli_ms) == TRAIN_STEPS and all(math.isfinite(x) for x in cli_losses),
          f"train_path: losses {cli_losses}")
    first, last = value
    check(lines[0].startswith("step     0 loss ") and lines[-1].startswith(
        f"done: loss {first:.4f} -> {last:.4f} over {TRAIN_STEPS} steps"),
        f"train_path: CLI printed {lines}")
    leaves = list(tree_leaves(state))
    check(all(a.device.type == "cuda" for _, a in leaves), "train_path: state not on the card")
    check(all(a.dtype == torch.float32 for p, a in leaves if p[0] != "step")
          and state["step"].dtype == torch.int32 and int(state["step"]) == TRAIN_STEPS,
          "train_path: state leaves not float32 (step int32)")
    n_params = sum(a.numel() for _, a in tree_leaves(state["params"]))
    warm_ms = statistics.median(cli_ms[TRAIN_COLD:])
    tokens = TRAIN_B * TRAIN_S
    flops = costs.model_flops(cfg, ShapeConfig("train_cli", TRAIN_S, TRAIN_B, "train"))
    # AdamW reads p, m, v and g and writes p, m and v: 7 float32 passes
    adamw_bytes = 7 * 4 * n_params
    flops_ms = flops / FP32_FLOPS_PER_S * 1e3
    bytes_ms = adamw_bytes / HBM_BYTES_PER_S * 1e3
    del state, leaves
    seen.pop("state")

    # the CLI's first step again on the CPU, from the same state and batch
    state0, batch0, got, gmet = seen.pop("first")
    want, wmet = build(cfg, _mesh11(torch, "cpu"), **seen["kw"])[0](state0, batch0)
    full_vs_cpu = _check_step(f"{TRAIN_ARCH} full width", seen["kw"]["opt"], got, gmet,
                              want, wmet)
    del state0, batch0, got, want
    mark("full_width_vs_cpu")

    long = counted({}, "S 4096", lambda: _train_long(torch))[0]
    mark("s4096")

    t0 = time.perf_counter()
    small = counted({}, "card vs CPU", lambda: _train_card_vs_cpu(torch))[0]
    small_s = time.perf_counter() - t0
    mark("card_vs_cpu")

    # kill at step 6, resume from the step-5 checkpoint, against a run
    # that was not interrupted
    base = os.path.join(ROOT, "build", "chip_smoke", "train")
    shutil.rmtree(base, ignore_errors=True)
    ck, full = os.path.join(base, "ck"), os.path.join(base, "full")
    code, kill_lines = counted({}, "the killed run", lambda: run_main(
        TRAIN_KILL + ("--ckpt-dir", ck, "--fail-at-step", "6")))[0]
    check(code == 17 and latest_step(ck) == 5 and "[fault-injection] hard exit at step 6"
          in kill_lines, f"train_path: killed run exited {code} at {latest_step(ck)}")
    _, resume_lines = counted({}, "the resumed run", lambda: run_main(
        TRAIN_KILL + ("--ckpt-dir", ck)))[0]
    resumed = seen["losses"]
    check("[resume] from step 5" in resume_lines and len(resumed) == 7,
          f"train_path: resumed run printed {resume_lines}, {len(resumed)} steps")
    counted({}, "the uninterrupted run", lambda: run_main(TRAIN_KILL + ("--ckpt-dir", full)))
    whole = seen["losses"]
    resume_diff = max(abs(a - b) / abs(b) for a, b in zip(resumed, whole[5:]))
    check(len(whole) == 12 and resume_diff <= TRAIN_RESUME_RTOL,
          f"train_path: resumed losses {resumed} against {whole[5:]}")
    shutil.rmtree(base, ignore_errors=True)
    mark("kill_resume")
    return {"arch": TRAIN_ARCH, "cli": list(TRAIN_CLI), "cli_s": cli_s, "cli_lines": lines,
            "n_params": n_params, "losses": cli_losses, "first_last": list(value),
            "ms_per_step": {"all": cli_ms, "warm_median": warm_ms},
            "tokens_per_s": tokens / (warm_ms / 1e3), "peak_mem_bytes": peak,
            "bound_ms_per_step": max(flops_ms, bytes_ms),
            "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
            "flops": flops, "flops_ms": flops_ms, "adamw_bytes": adamw_bytes,
            "bytes_ms": bytes_ms,
            "full_width_vs_cpu": {"step": 0, "max_rel_diff": full_vs_cpu},
            "s4096": long,
            "card_vs_cpu": {"rtol": TRAIN_RTOL, "m_atol": f"{TRAIN_M_SCALE} x max|cpu|",
                            "params": f"lr min(2, {2 * TRAIN_M_SCALE} max|m| / (|m| + 0.1 "
                                      f"eps)) + {TRAIN_P_SCALE} x max|cpu|",
                            "seq": TRAIN_SMALL_S, "q_chunk": TRAIN_SMALL_Q,
                            "kv_chunk": TRAIN_SMALL_KV, "max_rel_diff": small,
                            "seconds": small_s},
            "kill_resume": {"killed_at": 6, "resumed_from": 5, "resumed_steps": len(resumed),
                            "max_rel_diff_vs_uninterrupted": resume_diff,
                            "rtol": TRAIN_RESUME_RTOL},
            "stages_s": marks, **launched}


def _mesh_settings(torch):
    """The train CLI's settings and optimizer (``launch/train.py`` at
    ``--steps`` 100 or fewer)."""
    from repro_torch.models import ModelSettings
    from repro_torch.train.optim import OptConfig

    return (ModelSettings(q_chunk=32, kv_chunk=64, ce_chunk=64, remat="none",
                          compute_dtype=torch.float32),
            OptConfig(lr=1e-3, warmup_steps=20, total_steps=100))


def _bit_sums(torch, tree):
    """Per leaf, two int64 sums of its float32 bits, plain and weighted by
    position (mod 65521), on the host: equal bits give equal sums."""
    from repro_torch.models.common import tree_leaves

    out = []
    for _, a in tree_leaves(tree):
        b = a.reshape(-1).view(torch.int32).long()
        w = torch.arange(b.numel(), device=b.device) % 65521 + 1
        out += [b.sum(), (b * w).sum()]
    return torch.stack(out).cpu()


def _mesh_rank(rank: int, port: int, out_dir: str, t_spawn: float) -> None:
    """mesh_path (b): pod ``rank`` of the (2, 1, 1) mesh on the shared card,
    on its rows of each batch; writes ``mesh_rank{rank}.json``."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import ARCHS
    from repro_torch.data.tokens import DataConfig, batch_at
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.sharding import batch_shardings, local_tree
    from repro_torch.train.step import build_train_step, init_train_state

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2)
    try:
        boot = time.time() - t_spawn
        mesh = make_mesh((2, 1, 1), MESH_AXES, device="cuda")
        cfg = ARCHS[TRAIN_ARCH]
        st, opt = _mesh_settings(torch)
        state = init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0),
                                 grad_compress=MESH_METHOD, device="cuda")
        _, jit_for, _ = build_train_step(cfg, mesh, settings=st, opt=opt,
                                         grad_compress=MESH_METHOD)
        data = DataConfig(vocab=cfg.vocab, batch=TRAIN_B, seq=TRAIN_S, seed=0)
        ms, losses, same, rows_of = [], [], [], []
        for i in range(MESH_POD_STEPS):
            batch = {k: torch.from_numpy(v) for k, v in batch_at(data, i).items()}
            rows = local_tree(batch, batch_shardings(batch, mesh))
            rows_of.append(rows["tokens"].shape[0])
            step = jit_for(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, rows)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(met["loss"].item())
            sums = _bit_sums(torch, {k: state[k] for k in ("params", "m", "v")})
            both = [torch.empty_like(sums) for _ in range(2)]
            dist.all_gather(both, sums)
            same.append(bool(torch.equal(both[0], both[1])))
        with open(os.path.join(out_dir, f"mesh_rank{rank}.json"), "w") as f:
            json.dump({"rank": rank, "boot_s": boot, "ms_per_step": ms, "losses": losses,
                       "same_params_m_v": same, "rows": rows_of,
                       "grad_compress_ratio": met["grad_compress_ratio"].item(),
                       "grad_compress_leaves": met["grad_compress_leaves"].item()}, f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _topk_checks(torch, gc, flush, compressed: list, small: list, cfg) -> dict:
    """The first compressed step's checks: sent + residual == the grad in
    every leaf compressed, kept >= dropped in every block, and the card's
    top-k of the embedding's and of a padded leaf's corrected grad equal to
    the CPU's."""
    for (g, zero), (sent, res) in small:
        check(zero, "mesh_path: the first step's residual is not zero")
        want = (flush(g.float()) + 0.0).view(torch.int32)   # -0 as +0, as 0 + v gives
        got = (sent.float() + res + 0.0).view(torch.int32)
        check(torch.equal(got, want),
              f"mesh_path: sent + residual != grad in a {tuple(g.shape)} leaf")
    for (x, _ratio), (vals, idx) in compressed:
        flat = x.reshape(-1)
        bl = min(gc._BLOCK, flat.numel())
        pad = (-flat.numel()) % bl
        rows = torch.cat([flat, flat.new_zeros(pad)]).reshape(-1, bl).abs()
        keep = torch.zeros_like(rows, dtype=torch.bool).scatter_(1, idx.long(), True)
        kept_min = vals.abs().min(dim=1).values
        dropped_max = rows.masked_fill(keep, 0.0).max(dim=1).values
        check(bool((kept_min >= dropped_max).all()),
              f"mesh_path: a block of a {tuple(x.shape)} leaf dropped a larger |value| "
              "than it kept")
    embed = [c for c in compressed if c[0][0].numel() == cfg.vocab * cfg.d_model]
    padded = sorted((c for c in compressed if c[0][0].numel() % gc._BLOCK
                     and c[0][0].numel() > gc._BLOCK), key=lambda c: c[0][0].numel())
    check(len(embed) == 1 and padded, "mesh_path: no embedding or padded leaf compressed")
    out = {}
    for name, ((x, ratio), (vals, idx)) in (("embed", embed[0]), ("padded", padded[0])):
        t0 = time.perf_counter()
        cv, ci = gc.topk_compress(x.cpu(), ratio)
        cpu_s = time.perf_counter() - t0
        dense = gc.topk_decompress(vals, idx, x.shape)
        cpu_dense = gc.topk_decompress(cv, ci, x.shape)
        same = (_bit_equal(torch, vals.cpu(), cv) and torch.equal(idx.cpu(), ci)
                and _bit_equal(torch, dense.cpu(), cpu_dense))
        check(same, f"mesh_path: top-k of the {name} leaf on the card differs from the CPU's")
        out[name] = {"numel": x.numel(), "blocks": vals.shape[0], "k": vals.shape[1],
                     "bit_equal": same, "cpu_compress_s": cpu_s}
    return out


def phase_mesh(torch, tmp: str, sides: list[dict]) -> dict:
    """Training on a mesh with a "pod" axis and compressed gradients: (a) a
    (1, 1, 1) mesh in this process, dense and ``topk32`` steps from one
    state; (b) two processes on a (2, 1, 1) mesh sharing the card."""
    import math

    import torch.multiprocessing as mp

    from repro_torch.configs import ARCHS
    from repro_torch.core._xla import flush
    from repro_torch.data.tokens import DataConfig, batch_at
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train import grad_compress as gc
    from repro_torch.train.step import build_train_step, init_train_state

    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "mesh_path: TF32 matmuls are on; the float32 comparisons need them off")
    counted, launched = _launch_counter("mesh_path", sides)
    marks, t_mark = {}, time.perf_counter()

    def mark(name: str) -> None:
        nonlocal t_mark
        now = time.perf_counter()
        marks[name] = now - t_mark
        t_mark = now

    cfg = ARCHS[TRAIN_ARCH]
    st, opt = _mesh_settings(torch)
    data = DataConfig(vocab=cfg.vocab, batch=TRAIN_B, seq=TRAIN_S, seed=0)
    batches = [{k: torch.from_numpy(v) for k, v in batch_at(data, i).items()}
               for i in range(MESH_STEPS)]
    mesh = make_mesh((1, 1, 1), MESH_AXES, device="cuda")
    torch.cuda.empty_cache()
    init = init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0),
                            grad_compress=MESH_METHOD, device="cuda")
    leaf_sizes = [a.numel() for _, a in tree_leaves(init["params"])]
    n_params = sum(leaf_sizes)
    events, seen = [], {"first": False, "compress": [], "small": []}

    def run(state, jit_for):
        ms, losses, topk_ms = [], [], []
        for i, batch in enumerate(batches):
            seen["first"] = i == 0
            step = jit_for(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(met["loss"].item())
            topk_ms.append(sum(a.elapsed_time(b) for a, b in events))
            events.clear()
        seen["first"] = False
        return state, met, ms, losses, topk_ms

    # (a) dense steps: no grad_compress, the normal branch
    _, dense_for, _ = build_train_step(cfg, mesh, settings=st, opt=opt)
    dense = {k: tree_map(torch.clone, init[k]) for k in ("params", "m", "v", "step")}
    (_, dmet, dense_ms, dense_losses, _), dense_s, _ = counted(
        {}, "dense steps", lambda: run(dense, dense_for))
    check(all(math.isfinite(x) for x in dense_losses) and "grad_compress_ratio" not in dmet,
          f"mesh_path: dense losses {dense_losses}, metrics {sorted(dmet)}")
    del dense
    mark("dense")

    # (a) topk32 steps: each piece's top-k between CUDA events (on one
    # device each leaf is one piece), the first step's grads, corrected
    # grads and what each sends and keeps, for the checks
    corrected, piece = gc._corrected, gc._compress_piece
    grads = []

    def kept_corrected(g, r):
        # r is the state's residual, which the donated step then overwrites
        if seen["first"]:
            grads.append((g, not r.any()))
        return corrected(g, r)

    def timed_piece(x, units, bl, ratio):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        vals, idx, sent, res = out = piece(x, units, bl, ratio)
        b.record()
        events.append((a, b))
        if seen["first"]:
            seen["compress"].append(((x, ratio), (vals, idx)))
            seen["small"].append((grads.pop(0), (sent, res)))
        return out

    _, topk_for, _ = build_train_step(cfg, mesh, settings=st, opt=opt,
                                      grad_compress=MESH_METHOD)
    comp = init
    gc._corrected, gc._compress_piece = kept_corrected, timed_piece
    try:
        (state, cmet, topk_step_ms, topk_losses, topk_ms), topk_s, _ = counted(
            {}, "topk32 steps", lambda: run(comp, topk_for))
    finally:
        gc._corrected, gc._compress_piece = corrected, piece
    check(all(math.isfinite(x) for x in topk_losses)
          and cmet["grad_compress_ratio"].item() == MESH_RATIO
          and cmet["grad_compress_leaves"].item() == len(leaf_sizes),
          f"mesh_path: topk32 losses {topk_losses}, metrics "
          f"{ {k: v.item() for k, v in cmet.items()} }")
    check(topk_losses[0] == dense_losses[0],
          f"mesh_path: the first topk32 loss {topk_losses[0]} is not the dense "
          f"{dense_losses[0]} (same state and batch)")
    compressed, small = seen["compress"], seen["small"]
    n_tiny = sum(1 for n in leaf_sizes if n < 4 * MESH_RATIO)
    check(len(small) == len(leaf_sizes) - n_tiny == len(compressed),
          f"mesh_path: {len(small)} leaves compressed of {len(leaf_sizes)} ({n_tiny} tiny)")
    payload = sum(v.numel() * v.element_size() + i.numel() * i.element_size()
                  for _, (v, i) in compressed)
    payload += 4 * sum(n for n in leaf_sizes if n < 4 * MESH_RATIO)
    check(payload == gc.payload_bytes(init["params"], MESH_METHOD),
          f"mesh_path: the pod sent {payload} bytes, grad_compress.payload_bytes says "
          f"{gc.payload_bytes(init['params'], MESH_METHOD)}")
    del state, comp
    mark("topk")
    card_vs_cpu = _topk_checks(torch, gc, flush, compressed, small, cfg)
    del compressed, small
    seen.clear()
    mark("checks")

    # (b) two processes on the one card, a pod each
    out_dir = os.path.join(tmp, "mesh")
    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.empty_cache()
    port = _free_port()
    t_spawn = time.time()
    counted({}, "two pods", lambda: mp.spawn(_mesh_rank, args=(port, out_dir, t_spawn),
                                             nprocs=2, join=True))
    pods_s = time.time() - t_spawn
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"mesh_rank{r}.json")) as f:
            ranks.append(json.load(f))
    check(all(all(r["same_params_m_v"]) for r in ranks) and ranks[0]["losses"] == ranks[1]["losses"],
          f"mesh_path: the pods differ after a step: {ranks}")
    check(all(r["rows"] == [TRAIN_B // 2] * MESH_POD_STEPS for r in ranks),
          f"mesh_path: a pod's rows {[r['rows'] for r in ranks]}")
    loss_rel = abs(ranks[0]["losses"][0] - dense_losses[0]) / abs(dense_losses[0])
    check(loss_rel <= MESH_LOSS_RTOL,
          f"mesh_path: the pods' step-1 loss {ranks[0]['losses'][0]} against the dense "
          f"{dense_losses[0]}: {loss_rel} relative")
    mark("two_pods")
    warm = lambda ms: statistics.median(ms[1:])   # noqa: E731  (the first step warms up)
    return {"arch": TRAIN_ARCH, "batch": TRAIN_B, "seq": TRAIN_S, "n_params": n_params,
            "settings": "the train CLI's: float32, q 32 / kv 64 / ce 64, no remat, lr 1e-3",
            "one_pod": {"mesh": [1, 1, 1], "axes": list(MESH_AXES), "steps": MESH_STEPS,
                        "dense": {"ms_per_step": dense_ms, "warm_ms": warm(dense_ms),
                                  "losses": dense_losses, "seconds": dense_s},
                        "topk32": {"ms_per_step": topk_step_ms, "warm_ms": warm(topk_step_ms),
                                   "losses": topk_losses, "seconds": topk_s,
                                   "topk_ms_per_step": topk_ms,
                                   "topk_share": [a / b for a, b in zip(topk_ms, topk_step_ms)]},
                        "leaves": len(leaf_sizes), "tiny_leaves_dense": n_tiny,
                        "bytes_per_pod_step": {"dense": 4 * n_params, "topk32": payload,
                                               "ratio": 4 * n_params / payload},
                        "card_vs_cpu": card_vs_cpu},
            "two_pods": {"mesh": [2, 1, 1], "backend": "gloo", "steps": MESH_POD_STEPS,
                         "seconds": pods_s, "boot_s": [r["boot_s"] for r in ranks],
                         "ms_per_step": [r["ms_per_step"] for r in ranks],
                         "losses": ranks[0]["losses"],
                         "step1_loss_vs_dense_rel": loss_rel, "rtol": MESH_LOSS_RTOL},
            "stages_s": marks, **launched}


# dryrun_path: the most the dry run's peak may differ from the card's
DRYRUN_PEAK_RTOL = 0.25
# dryrun_path (e): the cell whose rank 0 runs on the card; what a device
# holds (an 80 GB H100)
RANK_ARCH = "qwen3-32b"
CARD_BYTES = 80e9
# dryrun_path (f): rank 0 of RANK_ARCH's train_4k topk32 step on the 2x16x16
# mesh, its depth cut from 64 layers to this (full width, the shape's 8 rows
# a rank in 4 micro-batches)
COMPRESS_LAYERS = 2
# (f)'s count: ``python -m repro_torch.launch.dryrun --arch qwen3-32b --shape
# train_4k --mesh multi --grad-compress topk32 --layers 2 --device cpu``'s
# argument_bytes + temp_bytes (PERF.md section 6, PR 30).  Counting takes
# over a minute, more than the phase's budget, so the run is held to this.
COMPRESS_COUNTED_PEAK = 12628279708


def _dryrun_cli(tmp: str, name: str, args: list[str]):
    """The dry run's CLI in a process of its own (a fake world of its own),
    its output to files under ``tmp``: (process, out dir, argv, log files)."""
    out_dir = os.path.join(tmp, name)
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    argv = [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out", out_dir]
    logs = [open(os.path.join(out_dir, n), "w+") for n in ("stdout", "stderr")]
    return subprocess.Popen(argv, env=env, cwd=ROOT, stdout=logs[0], stderr=logs[1]), \
        out_dir, argv, logs


def _finish(proc, logs) -> list[str]:
    """Ends ``proc`` if it still runs; its stdout and stderr."""
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    printed = []
    for f in logs:
        f.seek(0)
        printed.append(f.read())
        f.close()
    return printed


def start_dryrun_clis(tmp: str) -> dict:
    """dryrun_path's three processes, started before mesh_path so that
    their imports (most of their time) run beside it: (d) the CLI over
    decode_32k on both production meshes, (e) rank 0 of qwen3-32b's
    decode_32k on the 16x16 mesh, counted and then run on the card, (f)
    rank 0 of its train_4k topk32 step on the 2x16x16 mesh, cut to
    ``COMPRESS_LAYERS`` layers, run on the card (:func:`compress_rank`)."""
    t0 = time.perf_counter()
    out_dir = os.path.join(tmp, "compress_rank")
    os.makedirs(out_dir, exist_ok=True)
    logs = [open(os.path.join(out_dir, n), "w+") for n in ("stdout", "stderr")]
    argv = [sys.executable, "-c", "import sys, chip_smoke; chip_smoke.compress_rank(sys.argv[1])",
            out_dir]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return {"t0": t0,
            "d": _dryrun_cli(tmp, "dryrun", [
                "--arch", "smollm-135m", "--shape", "decode_32k", "--mesh", "both"]),
            "e": _dryrun_cli(tmp, "dryrun_rank", [
                "--arch", RANK_ARCH, "--shape", "decode_32k", "--mesh", "single", "--run"]),
            "f": (subprocess.Popen(argv, env=env, cwd=ROOT, stdout=logs[0], stderr=logs[1]),
                  out_dir, argv, logs)}


def compress_rank(out_dir: str) -> None:
    """dryrun_path (f), in a process of its own: rank 0 of ``RANK_ARCH``'s
    train_4k ``topk32`` step on the 2x16x16 mesh, cut to
    ``COMPRESS_LAYERS`` layers, run once on the card by
    ``launch.dryrun.run_cell`` (random blocks of the state, token ids 0, a
    512-rank world on the ``fake`` backend: the collectives return at once,
    the pods' exchange leaves this pod's payload).  The compress pass
    (``grad_compress.compress_blocks``, wrapped) between CUDA events, its
    peak (the peak stats reset at its start, the step's peak so far kept)
    and its pod exchanges (``_pod_gather`` calls) beside the plan's; writes
    ``compress_rank.json``."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import param_specs
    from repro_torch.train import grad_compress as gc
    from repro_torch.train.sharding import _zip_map
    from repro_torch.train.step import train_state_shardings

    t0 = time.perf_counter()
    dryrun._start_fake_world(512)
    try:
        mesh = make_production_mesh(multi_pod=True, device="cuda")
        cfg = dataclasses.replace(ARCHS[RANK_ARCH], n_layers=COMPRESS_LAYERS)
        moment_sh = train_state_shardings(cfg, mesh, grad_compress="topk32")["m"]
        plan = gc.compress_plan(_zip_map(lambda s, sh: torch.empty(
            sh.shard_shape(s.shape), device="meta"), param_specs(cfg), moment_sh), moment_sh)
        exchanges, passes = [0], []
        gather, compress = gc._pod_gather, gc.compress_blocks

        def counted_gather(*args):
            exchanges[0] += 1
            return gather(*args)

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            before = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = compress(*args, **kwargs)
            end.record()
            torch.cuda.synchronize()
            passes.append({"ms": start.elapsed_time(end),
                           "peak": torch.cuda.max_memory_allocated(), "step_before": before,
                           "exchanges": exchanges[0]})
            return out

        gc._pod_gather, gc.compress_blocks = counted_gather, timed
        run = dryrun.run_cell(cfg, SHAPES["train_4k"], mesh,
                              dryrun._settings(dryrun.parser().parse_args([])),
                              grad_compress="topk32", steps=1)
    finally:
        dist.destroy_process_group()
    (one,) = passes
    with open(os.path.join(out_dir, "compress_rank.json"), "w") as f:
        json.dump({"step_seconds": run["seconds"], "micro_batches": run["micro_batches"],
                   "argument_bytes": run["argument_bytes"],
                   "max_memory_allocated": max(run["max_memory_allocated"], one["step_before"]),
                   "compress": one, "leaves": len(plan),
                   "pieces": sum(len(p.pieces) for p in plan.values()),
                   "largest_piece": max(q.elements for p in plan.values() for q in p.pieces),
                   "planned_exchanges": sum(1 if p.tiny else len(p.batches)
                                            for p in plan.values()),
                   "process_s": time.perf_counter() - t0}, f)


def stop_dryrun_clis(clis: dict) -> None:
    """Ends the three processes if they still run (a phase before failed)."""
    for key in ("d", "e", "f"):
        proc, _, _, logs = clis[key]
        if not logs[0].closed:
            _finish(proc, logs)


def phase_dryrun(torch, tmp: str, sides: list[dict], train_ms: float, clis: dict) -> dict:
    """The dry run against the card: the train CLI's step counted on real
    and on fake cuda tensors, the dry run's peak against the card's, the
    step's bounds from its counts, the CLI over decode_32k on both
    production meshes in a subprocess (d), and in another (e) rank 0 of
    qwen3-32b's decode_32k on the 16x16 mesh counted and then run on the
    card: real blocks of its parameters and cache, a 256-rank world on the
    ``fake`` backend, its peak against the count's; in a third (f) rank 0
    of its train_4k topk32 step on the 2x16x16 mesh, cut in depth, run on
    the card.  ``clis`` are (d), (e) and (f), started earlier
    (:func:`start_dryrun_clis`)."""
    from repro_torch.configs import ARCHS, ShapeConfig

    counted, launched = _launch_counter("dryrun_path", sides)
    cfg = ARCHS[TRAIN_ARCH]
    st, opt = _mesh_settings(torch)
    mesh = _mesh11(torch, "cuda")
    shape = ShapeConfig("train_cli", TRAIN_S, TRAIN_B, "train")

    t_cli = clis["t0"]
    proc, out_dir, argv, logs = clis["d"]
    rank_proc, rank_dir, rank_argv, rank_logs = clis["e"]
    comp_proc, comp_dir, comp_argv, comp_logs = clis["f"]
    try:
        res = _dryrun_in_process(torch, counted, cfg, st, opt, mesh, shape, train_ms)
        _, wait_s, _ = counted({}, "the CLI", lambda: proc.wait(timeout=300))
        cli_s = time.perf_counter() - t_cli
        _, rank_wait_s, _ = counted({}, "the rank's step", lambda: rank_proc.wait(timeout=300))
        rank_s = time.perf_counter() - t_cli
        _, comp_wait_s, _ = counted({}, "the compressed rank's step",
                                    lambda: comp_proc.wait(timeout=300))
        comp_s = time.perf_counter() - t_cli
    finally:
        printed = _finish(proc, logs)
        rank_printed = _finish(rank_proc, rank_logs)
        comp_printed = _finish(comp_proc, comp_logs)
    check(proc.returncode == 0, f"dryrun_path: the CLI exited {proc.returncode}: "
                                f"{printed[0][-2000:]} {printed[1][-2000:]}")
    check(rank_proc.returncode == 0,
          f"dryrun_path: the rank's run exited {rank_proc.returncode}: "
          f"{rank_printed[0][-2000:]} {rank_printed[1][-2000:]}")
    check(comp_proc.returncode == 0,
          f"dryrun_path: the compressed rank's run exited {comp_proc.returncode}: "
          f"{comp_printed[0][-2000:]} {comp_printed[1][-2000:]}")
    rank = _rank_run(torch, rank_dir, rank_argv, rank_printed[0], rank_s, rank_wait_s)
    compressed = _compress_run(torch, comp_dir, comp_argv, comp_s, comp_wait_s)
    cells = {}
    for mesh_kind, n in (("single", 256), ("multi", 512)):
        with open(os.path.join(out_dir, f"smollm-135m__decode_32k__{mesh_kind}.json")) as f:
            cell = json.load(f)
        check(cell.get("applicable") is True and "error" not in cell
              and cell["n_devices"] == n and cell["flops_per_device"] > 0,
              f"dryrun_path: the CLI's {mesh_kind} cell: {cell}")
        mem = cell["memory"]
        cells[mesh_kind] = {
            "seconds": cell["time_lower_s"], "flops_per_device": cell["flops_per_device"],
            "bytes_per_device": cell["bytes_accessed_per_device"],
            "fused_bytes_per_device": cell["loop_aware"]["hbm_bytes_fused_per_device"],
            "collective_bytes_per_device": cell["collective_bytes_per_device"],
            "peak_bytes": mem["argument_bytes"] + mem["temp_bytes"],
            "argument_bytes": mem["argument_bytes"]}
        check(cells[mesh_kind]["peak_bytes"] < CARD_BYTES,
              f"dryrun_path: smollm-135m decode_32k on the {mesh_kind} mesh peaks at "
              f"{cells[mesh_kind]['peak_bytes']} B a device, over 80 GB")
    return {**res, "cli": {"argv": argv[1:], "seconds": cli_s, "waited_s": wait_s,
                           "lines": printed[0].splitlines(), "cells": cells},
            "rank_step": rank, "compressed_rank_step": compressed, **launched}


def _compress_run(torch, out_dir: str, argv: list, seconds: float, waited_s: float) -> dict:
    """(f): the cut train_4k topk32 rank's step on the card: its peak under
    the card's memory and within ``DRYRUN_PEAK_RTOL`` of its count, its
    pod exchanges the plan's and the loss's and ce's."""
    with open(os.path.join(out_dir, "compress_rank.json")) as f:
        run = json.load(f)
    peak, one = run["max_memory_allocated"], run["compress"]
    total = torch.cuda.get_device_properties(0).total_memory
    check(peak < min(total, CARD_BYTES),
          f"dryrun_path: {RANK_ARCH} train_4k topk32 rank 0 ({COMPRESS_LAYERS} layers) peaks "
          f"at {peak} B, over the card's {total}")
    ratio = peak / COMPRESS_COUNTED_PEAK
    check(abs(ratio - 1) <= DRYRUN_PEAK_RTOL,
          f"dryrun_path: {RANK_ARCH} train_4k topk32 rank 0 peaks at {peak} B on the card, "
          f"counted {COMPRESS_COUNTED_PEAK} (PERF.md): {ratio}")
    # the leaves' batches, and the loss and ce (the micro-batches' metric)
    check(one["exchanges"] == run["planned_exchanges"] + 2
          and one["exchanges"] <= 4 * run["leaves"],
          f"dryrun_path: the compress pass made {one['exchanges']} pod exchanges, planned "
          f"{run['planned_exchanges']} for {run['leaves']} leaves")
    print(f"dryrun_path: {RANK_ARCH} train_4k topk32 rank 0 ({COMPRESS_LAYERS} layers) "
          f"compress pass: {one['ms'] / 1e3} s, peak {one['peak']} B, {one['exchanges']} "
          f"pod exchanges ({run['pieces']} pieces, the largest {run['largest_piece']} "
          "values)", flush=True)
    print(f"dryrun_path: {RANK_ARCH} train_4k topk32 rank 0 on the card: "
          f"max_memory_allocated {peak} B (counted {COMPRESS_COUNTED_PEAK}, ratio {ratio}), "
          f"step {run['step_seconds']} s, process {seconds} s", flush=True)
    return {"arch": RANK_ARCH, "shape": "train_4k", "mesh": "multi", "grad_compress": "topk32",
            "reduced": {"n_layers": COMPRESS_LAYERS}, "argv": argv[1:], **run,
            "counted_peak_bytes": COMPRESS_COUNTED_PEAK, "ratio": ratio,
            "rtol": DRYRUN_PEAK_RTOL, "card_total_memory": total, "seconds": seconds,
            "waited_s": waited_s}


def _rank_run(torch, out_dir: str, argv: list, stdout: str, seconds: float,
              waited_s: float) -> dict:
    """(e): the rank's cell, counted and run on the card: its peak within
    ``DRYRUN_PEAK_RTOL`` of the count's and under the card's memory."""
    with open(os.path.join(out_dir, f"{RANK_ARCH}__decode_32k__single.json")) as f:
        cell = json.load(f)
    check(cell.get("applicable") is True and "error" not in cell and "run" in cell
          and cell["n_devices"] == 256, f"dryrun_path: the rank's cell: {cell}")
    run = cell["run"]
    card_peak, counted_peak = run["max_memory_allocated"], run["counted_peak_bytes"]
    total = torch.cuda.get_device_properties(0).total_memory
    ratio = card_peak / counted_peak
    check(abs(ratio - 1) <= DRYRUN_PEAK_RTOL,
          f"dryrun_path: {RANK_ARCH} decode_32k rank 0 peaks at {card_peak} B on the card, "
          f"counted {counted_peak}: {ratio}")
    check(card_peak < min(total, CARD_BYTES),
          f"dryrun_path: {RANK_ARCH} decode_32k rank 0 peaks at {card_peak} B, over the "
          f"card's {total}")
    print(f"dryrun_path: {RANK_ARCH} decode_32k rank 0 on the card: max_memory_allocated "
          f"{card_peak} B (counted {counted_peak}, ratio {ratio}), steps {run['seconds']} s, "
          f"process {seconds} s", flush=True)
    return {"arch": RANK_ARCH, "shape": "decode_32k", "mesh": "single", "argv": argv[1:],
            "max_memory_allocated": card_peak, "counted_peak_bytes": counted_peak,
            "ratio": ratio, "rtol": DRYRUN_PEAK_RTOL, "card_total_memory": total,
            "argument_bytes": run["argument_bytes"], "step_seconds": run["seconds"],
            "count_seconds": cell["time_lower_s"], "process_s": seconds,
            "waited_s": waited_s, "lines": stdout.splitlines()}


def _dryrun_in_process(torch, counted, cfg, st, opt, mesh, shape, train_ms: float) -> dict:
    """dryrun_path (a) to (c), in this process."""
    import dataclasses

    from repro_torch.data.tokens import DataConfig, batch_at
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import count_ops
    from repro_torch.models.common import tree_leaves
    from repro_torch.train.step import build_train_step, init_train_state

    # (a) the same step counted on the card and on fake cuda tensors
    torch.cuda.empty_cache()
    _, jit_for, _ = build_train_step(cfg, mesh, settings=st, opt=opt, donate=False)
    data = DataConfig(vocab=cfg.vocab, batch=TRAIN_B, seq=TRAIN_S, seed=0)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in batch_at(data, 0).items()}
    state = init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0),
                             device="cuda")
    step = jit_for(batch)
    step(state, batch)                                   # warm: cuBLAS and the allocator
    torch.cuda.synchronize()
    (_, card), card_s, _ = counted({}, "the counted step", lambda: count_ops(step, state, batch))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    fake, fake_s, _ = counted({}, "the dry run", lambda: dryrun.count_cell(
        cfg, shape, mesh, st, opt=opt))
    check(torch.cuda.memory_allocated() == before,
          "dryrun_path: the fake run allocated on the card")
    check(card == fake.stats, f"dryrun_path: the card's count {card} differs from the "
                              f"dry run's {fake.stats}")
    args = sum(a.numel() * a.element_size() for tree in (state, batch)
               for _, a in tree_leaves(tree))
    check(fake.argument_bytes == args,
          f"dryrun_path: argument bytes {fake.argument_bytes}, the step's inputs {args}")

    # (b) the dry run's peak against the card's, the step uncounted
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    card_peak = torch.cuda.max_memory_allocated() - live + args
    del out, state, batch
    ratio = fake.peak_bytes / card_peak
    check(abs(ratio - 1) <= DRYRUN_PEAK_RTOL,
          f"dryrun_path: the dry run's peak {fake.peak_bytes} against the card's "
          f"{card_peak}: {ratio}")
    print(f"dryrun_path: peak dry run {fake.peak_bytes} B, card {card_peak} B, "
          f"ratio {ratio}", flush=True)

    # (c) the step's bounds from its counts
    flops_ms = card.flops / FP32_FLOPS_PER_S * 1e3
    bytes_ms = card.hbm_bytes / HBM_BYTES_PER_S * 1e3
    fused_ms = card.hbm_bytes_fused / HBM_BYTES_PER_S * 1e3
    print(f"dryrun_path: train step {train_ms} ms (train_path, warm); bounds: flops "
          f"{flops_ms} ms, bytes {bytes_ms} ms (unfused), {fused_ms} ms (fused)", flush=True)

    return {"arch": TRAIN_ARCH, "batch": TRAIN_B, "seq": TRAIN_S,
            "settings": "the train CLI's: float32, q 32 / kv 64 / ce 64, no remat, lr 1e-3",
            "counts": dataclasses.asdict(card), "equal_card_and_fake": True,
            "counted_step_s": card_s, "fake_run_s": fake_s, "fake_count_s": fake.seconds,
            "step_ms_uncounted": step_ms,
            "peak": {"dry_run": fake.peak_bytes, "card": card_peak, "ratio": ratio,
                     "argument_bytes": args, "rtol": DRYRUN_PEAK_RTOL},
            "bounds": {"train_ms_warm": train_ms, "flops_ms": flops_ms, "bytes_ms": bytes_ms,
                       "fused_bytes_ms": fused_ms}}


def _max_abs_diff(got, want) -> float:
    if isinstance(got, tuple):
        return max(_max_abs_diff(a, b) for a, b in zip(got, want))
    return (got.double() - want.double()).abs().max().item()


def _bit_equal(torch, got, want) -> bool:
    """Equal bits; float32 tensors are compared as int32 (signed zeros too)."""
    if isinstance(got, tuple):
        return all(_bit_equal(torch, a, b) for a, b in zip(got, want))
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    return torch.equal(got, want)


def kernel_rows(torch, wv, zf, sz, ops, lkern, launches: dict,
                auto_launches: dict, region_launches: dict,
                dataset_launches: dict, parallel_launches: dict,
                serve_launches: dict, insitu_launches: dict) -> list[dict]:
    """One row per ported kernel at its path's shapes: the wavelet forward,
    zfpx and lorenzo encode over a QoI's 4096 blocks, the inverse, zfpx and
    lorenzo decode over one read-path chunk of 32 blocks; the wavelet
    kernels at n = 64 (block64_path): the forward over a QoI's 512 blocks,
    the inverse over one 4-block chunk; and the lorenzo decode at n = 64
    over a 4-block chunk and the wavelet staged kernel at n = 128 (B = 1,
    5 levels), sides that no path runs yet.  The lorenzo decode's rows also
    carry the design its library launches at their side.  The pack runs over
    the forward's output of the QoI's 4096 random blocks (nearly every
    detail kept), and its row carries its run on the in-situ cells' fields
    too (:func:`pack_euler512`)."""
    from repro_torch.kernels.wavelet_pack import pack_plain

    g = torch.Generator(device="cuda")
    g.manual_seed(34)
    kind, n, lv = "w3ai", 32, 3   # the main path's spec
    nblocks = (N_MAIN // n) ** 3
    x = torch.rand((nblocks, n, n, n), generator=g, device="cuda") * (2 * AMP) - AMP
    y = ops.wavelet_forward(x, kind, lv)
    chunk = y[:32].contiguous()
    ndense = ops.wavelet_pack(y, EPS, lv)[3].numel()  # nearly every detail, at +-50
    x64 = x.view(-1, 64, 64, 64)  # 512 blocks of 64^3 (4 levels), as random
    chunk64 = ops.wavelet_forward(x64, kind, 4)[:4].contiguous()
    x128 = x.view(-1, 128, 128, 128)[:1].contiguous()
    chunk128 = ops.wavelet_forward(x128, kind, 5)
    emax, q = ops.zfpx_encode(x, EPS)
    emax, q = emax[:32].contiguous(), q[:32].contiguous()
    res = ops.lorenzo_encode(x, EPS)[:32].contiguous()
    res64 = ops.lorenzo_encode(x64[:4].contiguous(), EPS)
    wsrc, zsrc, lsrc = ("src/repro_torch/kernels/csrc/wavelet3d.cu",
                        "src/repro_torch/kernels/csrc/zfp_transform.cu",
                        "src/repro_torch/kernels/csrc/lorenzo.cu")
    psrc = "src/repro_torch/kernels/csrc/wavelet_pack.cu"

    table = [
        ("wavelet3d_forward", wsrc, "src/repro/kernels/wavelet3d.py:139",
         "wavelet3d_cluster_kernel",
         lambda: ops.wavelet_forward(x, kind, lv), lambda: wv.forward3d(x, kind, lv),
         20, nblocks, wavelet_bound_ms(kind, n, lv, nblocks)),
        ("wavelet3d_inverse", wsrc, "src/repro/kernels/wavelet3d.py:145",
         "wavelet3d_cluster_kernel",
         lambda: ops.wavelet_inverse(chunk, kind, lv), lambda: wv.inverse3d(chunk, kind, lv),
         50, 32, wavelet_bound_ms(kind, n, lv, 32)),
        ("wavelet3d_forward_n64", wsrc, "src/repro/kernels/wavelet3d.py:139",
         "wavelet3d_cluster_kernel",
         lambda: ops.wavelet_forward(x64, kind, 4), lambda: wv.forward3d(x64, kind, 4),
         20, 512, wavelet_bound_ms(kind, 64, 4, 512)),
        ("wavelet3d_inverse_n64", wsrc, "src/repro/kernels/wavelet3d.py:145",
         "wavelet3d_cluster_kernel",
         lambda: ops.wavelet_inverse(chunk64, kind, 4), lambda: wv.inverse3d(chunk64, kind, 4),
         50, 4, wavelet_bound_ms(kind, 64, 4, 4)),
        ("wavelet_pack", psrc, "none (the host's selection in serialize)", "wavelet_pack_",
         lambda: ops.wavelet_pack(y, EPS, lv), lambda: pack_plain(y, EPS, lv),
         20, nblocks, pack_bound_ms(n, lv, nblocks, ndense)),
        ("zfpx_encode", zsrc, "src/repro/kernels/zfp_transform.py:56", "zfpx_encode_kernel",
         lambda: ops.zfpx_encode(x, EPS), lambda: zf.encode(x, EPS),
         20, nblocks, zfpx_bound_ms(n, nblocks, decode=False)),
        ("zfpx_decode", zsrc, "src/repro/kernels/zfp_transform.py:82", "zfpx_decode_kernel",
         lambda: ops.zfpx_decode(emax, q, EPS, n), lambda: zf.decode(emax, q, EPS, n),
         50, 32, zfpx_bound_ms(n, 32, decode=True)),
        ("lorenzo_encode", lsrc, "src/repro/kernels/lorenzo.py:57", "lorenzo_encode_kernel",
         lambda: ops.lorenzo_encode(x, EPS), lambda: sz.encode(x, EPS),
         20, nblocks, lorenzo_bound_ms(n, nblocks, decode=False)),
        ("lorenzo_decode", lsrc, "src/repro/kernels/lorenzo.py:63", "lorenzo_decode_cluster",
         lambda: ops.lorenzo_decode(res, EPS), lambda: sz.decode(res, EPS),
         50, 32, lorenzo_bound_ms(n, 32, decode=True)),
        ("lorenzo_decode_n64", lsrc, "src/repro/kernels/lorenzo.py:63", "lorenzo_decode_cluster",
         lambda: ops.lorenzo_decode(res64, EPS), lambda: sz.decode(res64, EPS),
         50, 4, lorenzo_bound_ms(64, 4, decode=True)),
        ("wavelet3d_forward_n128", wsrc, "src/repro/kernels/wavelet3d.py:139",
         "wavelet3d_staged_kernel",
         lambda: ops.wavelet_forward(x128, kind, 5), lambda: wv.forward3d(x128, kind, 5),
         20, 1, wavelet_bound_ms(kind, 128, 5, 1)),
        ("wavelet3d_inverse_n128", wsrc, "src/repro/kernels/wavelet3d.py:145",
         "wavelet3d_staged_kernel",
         lambda: ops.wavelet_inverse(chunk128, kind, 5), lambda: wv.inverse3d(chunk128, kind, 5),
         20, 1, wavelet_bound_ms(kind, 128, 5, 1)),
    ]
    # CUDA kernels per call: the staged wavelet kernel runs once per level and
    # axis, the pack's mask, scan and select kernels once each
    per_call = {"wavelet3d_forward_n128": 15, "wavelet3d_inverse_n128": 15, "wavelet_pack": 3}
    designs = {"lorenzo_decode": lkern.decode_design(n),
               "lorenzo_decode_n64": lkern.decode_design(64),
               "wavelet_pack": {"details": ndense}}
    rows = []
    for name, src, replaces, symbol, call, plain, reps, blocks, (b_ms, b_by) in table:
        got, want = call(), plain()
        err = _max_abs_diff(got, want)
        check(_bit_equal(torch, got, want), f"{name} vs plain at its path's shape: not bit-exact")
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "auto_path_launches": auto_launches[name],
            "region_path_launches": region_launches[name],
            "dataset_path_launches": dataset_launches[name],
            "parallel_path_launches": parallel_launches[name],
            "serve_path_launches": serve_launches[name],
            "insitu_path_launches": insitu_launches[name],
            "max_abs_err": err,
            "ms": kernel_ms(call, symbol, reps, per_call.get(name, 1)),
            "call_ms": median_ms(call, reps),
            "plain_ms": median_ms(plain, 5, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "blocks": blocks, **designs.get(name, {}),
        })
    next(r for r in rows if r["name"] == "wavelet_pack")["euler512"] = pack_euler512(torch, ops)
    return rows


def main() -> int:
    t_script = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found; run from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    from repro_torch.core import szx as sz
    from repro_torch.core import wavelets as wv
    from repro_torch.core import zfpx as zf
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import lorenzo as lkern
    from repro_torch.kernels import wavelet3d as wkern

    card = smi()
    emit({"phase": "card", "nvidia_smi": card, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    print(card, flush=True)

    t0 = time.perf_counter()
    libs = [_build.BUILD_DIR / f"lib{name}.so" for name in KERNEL_SOURCES]
    for lib in libs:  # build from the sources, never from an earlier run
        if lib.exists():
            lib.unlink()
    _build.load_all()  # one nvcc per source, all started together
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [str(lib) for lib in libs], "flags": list(_build.NVCC_FLAGS)})

    tmp = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    sides = [wkern.LAUNCHES_BY_SIDE, lkern.LAUNCHES_BY_SIDE]
    dryrun_clis = None
    try:
        t0 = time.perf_counter()
        parity = phase_parity(torch, wv, ops)
        parity["zfpx"] = phase_zfpx_parity(torch, zf, ops)
        parity["lorenzo"] = phase_lorenzo_parity(torch, sz, ops)
        parity["interop"] = phase_interop(tmp)
        emit({"phase": "parity", "seconds": time.perf_counter() - t0, **parity})
        t0 = time.perf_counter()
        bits = phase_bits(torch, wv, sz, ops)
        emit({"phase": "bits", "seconds": time.perf_counter() - t0, **bits})
        region = {k: os.path.join(tmp, "region", f"{k}.cz") for k in REGION_CONTAINERS}
        main_path = run_cli_path(tmp, "main_path", [], "CompressionSpec() defaults",
                                 lambda _m: 100 * EPS,
                                 ("wavelet3d_forward", "wavelet_pack", "wavelet3d_inverse"),
                                 sides,
                                 keep=region["wavelet"])
        emit({"phase": "main_path", **main_path})
        block64_path = run_cli_path(tmp, "block64_path", ["--block-size", "64"],
                                    "CompressionSpec(block_size=64): w3ai, eps 1e-3, 4 "
                                    "levels, byte shuffle, zlib", lambda _m: 100 * EPS,
                                    ("wavelet3d_forward", "wavelet_pack",
                                     "wavelet3d_inverse"), sides,
                                    ("p",))
        emit({"phase": "block64_path", **block64_path})
        zfpx_path = run_cli_path(tmp, "zfpx_path", ["--scheme", "zfpx"],
                                 "CompressionSpec(scheme='zfpx'): eps 1e-3, 32^3 blocks, "
                                 "byte shuffle, zlib", lambda _m: ZFPX_BOUND,
                                 ("zfpx_encode", "zfpx_decode"), sides,
                                 ZFPX_PATH_QOIS, keep=region["zfpx"])
        emit({"phase": "zfpx_path", **zfpx_path})
        lorenzo_path = run_cli_path(tmp, "lorenzo_path", ["--scheme", "lorenzo"],
                                    "CompressionSpec(scheme='lorenzo'): eps 1e-3, 32^3 "
                                    "blocks, byte shuffle, zlib", lorenzo_bound,
                                    ("lorenzo_encode", "lorenzo_decode"), sides,
                                    LORENZO_PATH_QOIS, keep=region["lorenzo"])
        emit({"phase": "lorenzo_path", **lorenzo_path})
        t0 = time.perf_counter()
        fpzipx = phase_fpzipx(tmp)
        emit({"phase": "fpzipx", "seconds": time.perf_counter() - t0, **fpzipx})
        t0 = time.perf_counter()
        from repro_torch.fields import CloudConfig, cavitation_fields

        p512 = cavitation_fields(CloudConfig(n=N_MAIN), T_MAIN, device="cuda")["p"]
        auto_interop = phase_auto_interop(tmp, p512)
        emit({"phase": "auto_interop", "seconds": time.perf_counter() - t0, **auto_interop})
        t0 = time.perf_counter()
        auto_trials = phase_auto_trials(torch, wv, zf, sz, ops, p512)
        emit({"phase": "auto_trials", "seconds": time.perf_counter() - t0, **auto_trials})
        t0 = time.perf_counter()
        serve_root = os.path.join(tmp, "serve_dataset")
        dataset_path = phase_dataset(tmp, p512, region["wavelet"], sides, keep=serve_root)
        emit({"phase": "dataset_path", "seconds": time.perf_counter() - t0, **dataset_path})
        t0 = time.perf_counter()
        parallel_path = phase_parallel(tmp, p512, region["wavelet"], sides)
        emit({"phase": "parallel_path", "seconds": time.perf_counter() - t0, **parallel_path})
        t0 = time.perf_counter()
        serve_path = phase_serve(tmp, p512, region["wavelet"], serve_root, sides)
        del p512
        shutil.rmtree(serve_root, ignore_errors=True)
        emit({"phase": "serve_path", "seconds": time.perf_counter() - t0, **serve_path})
        auto_path = run_cli_path(tmp, "auto_path", ["--scheme", "auto", "--target", "abs=1e-3"],
                                 "CompressionSpec(scheme='auto', extra={'target': "
                                 "'abs=1e-3'}): 32^3 blocks, 4 MiB chunks, byte shuffle, "
                                 "zlib", auto_bound, tuple(KERNEL_LABELS), sides,
                                 ("p",), recorded="host", keep=region["auto"])
        emit({"phase": "auto_path", **auto_path})
        t0 = time.perf_counter()
        region_results, region_path = phase_region(region, sides)
        for name, res in region_results.items():
            emit({"phase": "region_path", "container": name, **res})
        emit({"phase": "region_path", "seconds": time.perf_counter() - t0, **region_path})
        t0 = time.perf_counter()
        insitu_path = phase_insitu(torch, tmp, sides)
        emit({"phase": "insitu_path", "seconds": time.perf_counter() - t0, **insitu_path})
        t0 = time.perf_counter()
        llm_path = phase_llm(torch, sides)
        emit({"phase": "llm_path", "seconds": time.perf_counter() - t0, **llm_path})
        t0 = time.perf_counter()
        train_path = phase_train(torch, sides)
        emit({"phase": "train_path", "seconds": time.perf_counter() - t0, **train_path})
        t0 = time.perf_counter()
        dryrun_clis = start_dryrun_clis(tmp)
        mesh_path = phase_mesh(torch, tmp, sides)
        emit({"phase": "mesh_path", "seconds": time.perf_counter() - t0, **mesh_path})
        t0 = time.perf_counter()
        dryrun_path = phase_dryrun(torch, tmp, sides, train_path["ms_per_step"]["warm_median"],
                                   dryrun_clis)
        emit({"phase": "dryrun_path", "seconds": time.perf_counter() - t0, **dryrun_path})
        print(card, flush=True)
    finally:
        if dryrun_clis is not None:
            stop_dryrun_clis(dryrun_clis)
        shutil.rmtree(tmp, ignore_errors=True)
    # each kernel's launches on its own path
    wavelet = ("wavelet3d_forward", "wavelet3d_inverse")
    launches = {k: main_path["launches"][k] for k in (*wavelet, "wavelet_pack")}
    launches.update({f"{k}_n64": block64_path["launches"][k] for k in wavelet})
    launches.update({k: zfpx_path["launches"][k] for k in ("zfpx_encode", "zfpx_decode")})
    launches.update({k: lorenzo_path["launches"][k]
                     for k in ("lorenzo_encode", "lorenzo_decode")})
    # the rows at sides of their own: launches at that side, summed over
    # every path's run (each counted from 0)
    runs = (main_path, block64_path, zfpx_path, lorenzo_path, auto_path)
    for row, key in (("lorenzo_decode_n64", "lorenzo_decode n=64"),
                     ("wavelet3d_forward_n128", "wavelet3d_forward n=128"),
                     ("wavelet3d_inverse_n128", "wavelet3d_inverse n=128")):
        launches[row] = sum(run["launches_by_side"].get(key, 0) for run in runs)
    t0 = time.perf_counter()
    rows = kernel_rows(torch, wv, zf, sz, ops, lkern, launches, _path_rows(auto_path),
                       _path_rows(region_path), _path_rows(dataset_path),
                       _path_rows(parallel_path), _path_rows(serve_path),
                       _path_rows(insitu_path))
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0})
    emit({"phase": "total", "seconds": time.perf_counter() - t_script})
    print(card, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
