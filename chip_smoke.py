#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the repository root on a machine with a card:
``python3 chip_smoke.py``. It builds the CUDA kernels from
``ompi_release_tpu_torch/csrc`` with ``nvcc``, then:

1. prints the card (``nvidia-smi`` name and power limit), the build
   time and each kernel's registers, shared memory and spills (ptxas
   ``-v``, kept by the build), and each flash kernel's tensor-core
   (``HGMMA``) and atomic instructions from ``cuobjdump -sass``: the
   bf16 forward and the two bf16 backward kernels must hold HGMMA and no
   atomic;
2. holds each kernel against its plain PyTorch twin on the card: the
   streaming kernels (sum, axpy, scale) bitwise, f32 and bf16, at sizes
   1, 4097, 2^26+3 and a view at element offset 1, and around their one
   partition's vector, its block and a grid of many blocks
   (``cuda_op.stream_boundary_sizes``), aligned and at offset 1; the
   transpose bitwise at (8192, 8192) int32, (4097, 1000) f32 and (1, 1);
   the chain hop bitwise against ``x + 1``; the tuned ring allreduce's
   ``ring_fold`` kernel bitwise its plain twin and the interpreted ring
   of the plain, pipelined and segmented bodies at 2, 3, 5, 8, 9 and 16
   ranks, f32 and bf16, aligned and at offset 1, and not taken under op
   ^cuda;
   the flash-attention forward causal and not, S in {1, 100, 129, 2048},
   D in {8, 64, 128}, f32 and bf16, at the model's (64, 2048, 64) and,
   in 128-wide heads, (32, 2048, 128) bf16 causal, and with the bf16
   kernel's element loads (D 20 and 72, a view at element offset 1)
   (out f32 rtol/atol 2e-5, bf16 within one bf16 ulp plus 2e-5, lse atol
   1e-5: both compute in f32 in another summation order);
   the flash-attention backward kernels (dq, and dk/dv) each against its
   own plain twin, causal and not, S in {1, 100, 129, 256}, D in {8, 64,
   128}, f32 and bf16, the whole backward at the model's shape, run
   twice and bitwise equal, and at the model's width in 128-wide heads,
   (32, 2048, 128) bf16 causal (f32 rtol/atol 2e-4, the JAX suite's grad
   tolerance; bf16 within one bf16 ulp plus 2e-4: each gradient is an
   f32 sum of up to S products in another order on each side); then
   logs, ungated, whether cuBLAS reduces the trunk's bf16 products in
   bf16 (``column_parallel`` with
   ``allow_bf16_reduced_precision_reduction`` on and off against the f32
   product rounded once);
3. drives the main path, each slice's part with every launch counter
   set to 0 just before and read just after:
   - slice 1: ``init()`` with 8 virtual ranks on ``cuda:0``, a tuned
     communicator, allreduce f32 SUM from 8 B to 256 MiB per rank,
     reduce_scatter_block, bcast, allgather, alltoall, the fused
     allreduce on WORLD and the axpy/scale bench loops; every result is
     checked bitwise against the same calls with ``--mca op ^cuda``
     (the plain add on the card) and against closed forms;
   - slice 2: the ported ring example (ring over the first 4 of the 8
     ranks), a 256 MiB f32 send/recv from rank 0 to rank 5 (pipelined
     protocol), sendrecv/ring_shift/halo_exchange on 8 ranks, and the
     transpose and chain loops (eager and graph-replayed); each checked
     against its closed form;
   - slice 3: the flagship TpuLM's eval forward at full width
     (``ModelConfig()``: vocab 32000, d_model 512, 8 layers, 8 x 64
     heads, d_ff 2048, bf16, random weights from seed 0) over 3 batches
     of (8, 2048) tokens with ``attn_impl="auto"``: the flash kernel
     must launch 8 layers x 3 batches = 24 times, each loss must be
     finite and within 1.0 of ln(32000), and the first batch must give
     the same loss through ring attention (bf16 rel 1e-2; in f32 rel
     1e-4, f32 products in full f32: TF32 off);
   - slice 4: the TpuLM train step at full width (a fresh
     ``TpuLM(ModelConfig())`` from seed 0, ``adamw(1e-3)``) for 4 steps
     on one fixed (8, 2048) batch: ``flash_fwd``, ``flash_bwd_dq`` and
     ``flash_bwd_dkv`` must each launch 8 layers x 4 steps = 32 times,
     every loss must be finite and the last below the first; then, from
     the state those steps left, one step's loss and gradients through
     the kernels (``"flash"``) against plain autograd through ring
     attention (``"ring"``): loss rel 1e-2, every parameter's gradient
     within a relative L2 error of 3e-2 (bf16);
   - slice 5: the switch-MoE TpuLM at full width (``ModelConfig(
     n_experts=4)``, capacity factor 1.25, seed 0): one eval batch and 3
     ``adamw(1e-3)`` steps on one fixed (8, 2048) batch; the flash
     kernels must launch 8 times per forward and 8 + 8 per backward, the
     loss must be within 1.0 of ln(32000) at init, finite and falling;
     ``moe_layer`` at (16384, 512) bf16 against an independent
     gather-based reference (the experts' queues bitwise, the output
     within one bf16 ulp plus 1e-5, some tokens dropped); the tiny MoE
     config's loss (rel 1e-5) and gradients (relative L2 2e-4) on the
     card against the CPU, f32, through the flash kernels and their
     twins; the full-width Mixer (``MixerConfig()``, 1,024 patch tensors,
     ``sgd(0.1)``): two steps' losses on the card against the CPU from
     the same weights, bf16 rel 1e-2 and f32 rel 1e-4 (TF32 off), falling;
   - slice 6 (right after slice 1, on its WORLD and tuned comm): the
     datatype engine (the eight BLOCK x CYCLIC(64) darray pieces of an
     (8192, 8192) f32 array pack to plain indexing and unpack to the
     array bitwise; a subarray face and a vector column round-trip;
     external32 of a 4 MiB strided f32 and a bf16 payload; the on-card
     checksum of 256 MiB equals a host sum); tuned gather/scatter
     linear and binomial at 64 MiB per rank, roots 0 and 5, against
     closed forms; scan/exscan at 64 MiB (WORLD defers to tuned's
     recursive doubling) and 4 KiB (fused) equal ``torch.cumsum`` on
     integer-valued inputs and the op ^cuda run on random ones;
     allgatherv/gatherv/scatterv/reduce_scatter over counts 1:2:...:8
     (256 MiB); ``dropless_moe`` over ranks 0-3 with the full-width MoE
     TpuLM's layer-0 router assignments of the (8, 2048) batch (bf16,
     width 512), every output bitwise ``expert_fn(assign, token)``, its
     alltoallv against MPI_Alltoallv on the host; the fusion buffer over
     the full-width TpuLM's 66 gradient tensors at the default cvars
     and at threshold 64 MiB / capacity 25 MiB (8 x the input exactly;
     the op ^cuda buckets' bits); ``ml`` at 2 x 4 (allreduce, reduce,
     reduce_scatter_block at 256 MiB, bcast/allgather/alltoall at 64
     MiB) against closed forms and op ^cuda; a tuning-database entry
     that makes a 16 MiB tuned allreduce take ring, bitwise equal to
     ring forced. ``stream_axpy[sum]`` or the tuned ring's ``ring_fold``
     must launch on fusion's calls, ``stream_axpy[sum]`` on ml's. Then
     its timings: pack/unpack of a darray piece beside
     ``index_select``, the dropless alltoallv, the gradient list fused
     two ways and per tensor, ml against tuned at 256 MiB, scan at 64
     MiB;
   - slice 7 (right after slice 6): every collective above already went
     through ``coll/plan.py``, a seen signature replaying its CUDA
     graph. On the tuned comm each i-collective (13 families) and
     ``ibarrier`` at 4 MiB a rank, three fires each, equals its blocking
     call with ``coll_compiled=false`` bitwise, the SUM also op ^cuda; a
     steady 256 MiB ``iallreduce`` returns before it completes (test()
     false, dispatch ms < completion ms); ``allreduce_init`` on a 256
     MiB buffer started 10 times with its contents redrawn in place
     equals the interpreted call bitwise each time (1 capturing fire, 9
     hits); the main path's families (allreduce at 8 B-256 MiB, bcast,
     allgather, reduce_scatter_block, alltoall) capture as graphs on
     tuned, fused, ml and basic (none "bad"), each replay bitwise the
     interpreted leg; a profiler window sees the tuned ring's
     ``ring_fold`` kernel in every replay; a replay after the index cache is cleared and its memory
     overwritten gives the same bits; a tuned cvar write re-captures at
     the next fire and follows the forced algorithm; BASELINE config 5's
     int32 alltoall at 8 MiB a rank on the (4, 2) periodic cart comm
     equals the closed-form permutation, its neighbor_allgather/alltoall
     at 16 MiB a rank and their ineighbor twins index-built expectations;
     a 4 + 4 intercomm over WORLD's halves: the inter-allreduce at 64 MiB
     equals op ^cuda, merge orders low first; freeing a comm returns its
     graphs' memory; a host-syncing body fails its capture, stays
     interpreted and gives the interpreted bits. Then its timings, the
     plan and the interpreted leg in turns: the tuned allreduce at the
     six sweep sizes, a persistent start at 256 MiB beside iallreduce,
     host µs per 8 B fire, the 66-tensor gradient list
     one allreduce per tensor, profiler windows of each, the input copy
     and output clone a replay adds at 256 MiB, and peak memory;
   - slice 8 (right after slice 7): one-sided windows on WORLD, each
     epoch's planned leg (close 1 interpreted, close 2 captures the
     unrolled close as a CUDA graph, later closes replay it) against
     the same epochs with ``osc_compiled`` false, bitwise, and every
     plan must be a graph: a parameter-server window of 8 x 64 MiB f32
     (10 fence epochs of 7 accumulates of fresh 64 MiB gradients into
     rank 0 and a get, also against the sums taken in the same order on
     the host), a (8, 16 MiB) bf16 window filled by 32 indexed puts and
     a get per lock epoch (rank 3) and PSCW epoch (rank 5), and 1,024
     fetch_and_op(SUM) + 1,024 compare_and_swap calls on one int32
     element of a (8, 2^20) window against the closed form; SHMEM on a
     tuned comm of its own: a (8, 16 MiB) f32 heap through the bulk path
     equals the per-call path on every PE, ``sum_to_all`` at 64 MiB a PE
     equals the op ^cuda call and must launch the tuned ring's
     ``ring_fold``, 4 threads contending for one lock keep 100
     increments; a File of 8 x
     32 MiB card blocks under a vector view and a 256 MiB sharded array
     read back bitwise. Then its timings: epoch-close ms, host µs and
     ``osc_orchestration_seconds`` per close, replayed against
     interpreted in turns, at bench.py's ``rma_steady`` sizes and 64
     MiB, a profiler window of 64 MiB replays, SHMEM rounds bulk against
     per call, File and sharded GB/s, peak memory. After the slice-4
     check, a ``Checkpointer`` async save of the full-width TpuLM's
     parameters and AdamW state, a train step in place before its wait,
     and a restore bitwise the state at the save;
   - slice 9 (after the Mixer's timings): the full-width TpuLM over 8
     virtual ranks of the card in dryrun_multichip's two factorizations.
     Mesh A, dp 2 x pp 2 x tp 2 with 2 microbatches (dense): 1 eval batch
     and 4 ``adamw(1e-3)`` steps; the flash kernels must launch 12 times
     a forward (3 GPipe ticks x the stage's 4 layers, each launch over
     every rank) and 12 + 12 a backward, ``stream_axpy[sum]`` must launch
     (the tp psums); mesh B, dp 2 x sp 2 x ep 2 with 4 experts and
     capacity factor 4.0: 1 eval and 3 steps through ring attention (no
     flash at sp > 1). Each mesh's losses near ln(32000) and falling, its
     step-1 loss within rel 1e-4 and step-2 loss within rel 1e-3 / abs
     1e-4 of the one-card model from the same seed-0 weights and batch
     (for mesh B the one-card MoE runs its batch as 8 microbatches: at
     capacity 4.0 nothing is dropped either way). The full-width Mixer at
     dp 2 x tp 2: two ``sgd(0.1)`` steps against one card, f32 rel 1e-4,
     bf16 rel 1e-2. tree_allreduce / tree_reduce_scatter /
     tree_allgather over the TpuLM's 66 gradients on dp = 8: bitwise the
     per-leaf folds and the op ^cuda run. Then each mesh's step beside
     the one-card step in turns, a profiler window each, peak memory.
     ``python3 chip_smoke.py --slice9`` runs this phase alone (no result
     line);
   - slice 10 (run right after the kernel checks, while this process
     holds little on the card; its timings print after slice 1's, beside
     them): the multi-process plane. The
     parent builds the kernel library and the native control-plane
     library, then runs a ``tools.tpurun`` job of 2 workers (this script
     with ``--slice10-worker``), each owning 4 virtual ranks of
     ``cuda:0``: COMM_WORLD spans 8 ranks over 2 processes. Each worker
     drives allreduce f32 SUM from 8 B by powers of 4 to 128 MiB and 256
     MiB per rank, bcast, allgather (bf16), reduce_scatter_block and
     alltoall at slice 1's shapes, every ``hier`` inter schedule at 1
     MiB and 64 MiB, the ring example over all 8 ranks, a 256 MiB send
     0 -> 5, an ssend and an ANY_SOURCE probe; every result bitwise its
     closed form (integer-valued inputs) and the ``--mca op ^cuda``
     call; ``stream_axpy[sum]`` must launch in every allreduce of >= 4
     MiB and in both folds (the shadow comm's alone, then the spanning
     call); the shadow comm's allreduce plans must be CUDA graphs and
     the spanning comm must freeze no in-process plan. Then per worker:
     ping-pong GB/s 0 <-> 5, staging GB/s each way, peak memory and the
     card's memory in use;
   - slice 11, in the same workers right after slice 10: the spanning
     fast path. nativewire must be the co-hosted peer's transport, its
     byte counter must move, with no forced copy and no byte through a
     shm segment; every plannable family (allreduce, bcast, allgather,
     reduce, gather, scatter, reduce_scatter_block, reduce_scatter,
     alltoall, scan, exscan) at 8 B, 1 MiB, 64 MiB and 256 MiB per rank,
     and a bf16 SUM allreduce at 4 MiB and 256 MiB, is called
     interpreted (its c_coll entry, what coll_compiled=0 runs), fired
     once (the frozen wire plan recorded) and replayed 3 times (once
     for a 256 MiB signature other than allreduce), each bitwise the
     closed form, then called with ``--mca op ^cuda``, bitwise the
     closed form; ``cache_stats`` must count the spanning plans and
     ``coll_compiled_cache_hits`` the replays; each signature's
     executor (native, planned) and the reason a plan stayed on
     PlannedXchg print, a planned replay must have a reason, and the
     256 MiB allreduces must replay planned because their messages
     exceed the shm ring; bench.py's native_rounds cases under
     recursive doubling (allreduce 4 KiB / 256 KiB / 1 MiB, bcast 4 KiB /
     256 KiB, allgather 64 KiB): the interpreted, PlannedXchg and C
     executor legs bitwise equal, every replay fired by the C executor,
     no fallback; a replayed 256 MiB allreduce must launch
     ``stream_axpy[sum]`` as often as the interpreted call; iallreduce
     and ibcast give the blocking bits, an allreduce_init follows its
     buffer over 3 starts. Then: allreduce ms and bus GB/s per size
     (slice 10's sizes), interpreted and replayed in turns, with
     ``hier_inter_bytes`` per call; host µs per fire at 8 B; one
     profiled replayed 256 MiB allreduce (busy share, top kernels, host
     gaps); peak memory and the card's memory in use. A second job
     with a distinct ``OMPITPU_HOST_ID`` per worker runs a 64 MiB
     allreduce twice (record, replay) and a 64 MiB send on nativewire's
     socket leg (``wire_native_bytes`` > 0, no forced copy,
     ``wire_bytes_zero_copy`` > 0). Each job must exit 0 and leave no
     worker, no shm segment and no shm ring behind.
     ``python3 chip_smoke.py --slice10`` runs slices 10 and 11 alone and
     ``--slice11`` slice 11 alone (no result line);
   - slice 12, right after slices 10 and 11, in a job of its own (2
     workers x 4 virtual ranks of ``cuda:0``): the rest of the
     multi-process plane. A parameter-server wire window of 8 x 64 MiB
     f32 (5 fence epochs, each worker accumulating 64 MiB into each of
     the other worker's 4 slices, plus a get): the window and every get
     equal to the closed form, the home's epoch plans CUDA graphs, one
     frozen batch template rendering the later batches; a bf16 KV-cache
     fill (16 MiB a rank) by indexed puts in PSCW epochs across the
     boundary; 2 threads per worker incrementing rank 0's counter under
     its exclusive lock (each thread a window of its own; no lost
     update); 256 fetch_and_op and 256 compare_and_swap on one remote
     int32; SHMEM with a 16 MiB heap (put, get, atomic_fetch_add to a
     remote PE, ``shmem_ptr`` of it raising ERR_RMA_SHARED) and
     ``sum_to_all`` at 64 MiB a PE (the closed form, op ^cuda,
     ``stream_axpy[sum]`` launching); ``write_at_all`` of a 256 MiB file
     in per-rank blocks interleaving the workers, then ``read_at_all``,
     the file's bytes the closed form; ``dropless_moe`` over ranks 2-5
     at slice 6's MoE shapes, bitwise expert_fn per token; the tree pass
     over the TpuLM's 66 gradients (integer-valued), blocking and under
     the progress thread, bitwise the per-leaf allreduce with
     ``stream_axpy[sum]`` launching; ``HostPipeline`` with one stage per
     rank, 8 microbatches of (8 x 2048, 512) f32, nonblocking bitwise
     blocking and the closed form; dpm: publish/lookup, accept/connect
     between the workers' local comms, an intercomm send and an
     allreduce over its merge, lookups of closed ports raising
     ERR_PROC_FAILED; ``comm_spawn`` of one child (``--slice12-child``)
     that echoes bytes and exits 0. Then per worker: ms per 64 MiB
     remote-accumulate epoch interpreted and replayed in turns, µs per
     remote AMO, two-phase write and read GB/s, ``stream_axpy[sum]``
     launches and peak memory. ``python3 chip_smoke.py --slice12`` runs
     it alone (no result line);
   - slice 13, right after slice 12: fault tolerance, in three
     ``tools.tpurun`` jobs of 3 workers x 2 virtual ranks of ``cuda:0``
     (this script with ``--slice13-worker``), heartbeats every 0.3 s,
     miss limit 3. Job C (``--ft-continue``): a 16 B allreduce frozen
     and fired by the C plan executor, then worker 2 dies between fires;
     both survivors' next fire raises ERR_PROC_FAILED or ERR_REVOKED
     within 5 s of the kill, a C fire stopped by its raised fault word.
     Jobs A and B run ``ElasticStep`` over a data-parallel train step
     of the full-width TpuLM (seed-0 weights, flash attention): each
     rank's (1, 2048) Zipf-drawn tokens from the seed (step, world rank),
     the 66 per-layer f32 gradients summed by the tree pass over the
     spanning world under ``tuned,basic,self,hier``, AdamW; each rank's
     (step + 1) * (world rank + 1) and loss ride a 16 B allreduce;
     checkpoints every 2 steps into a temporary directory. Job A
     (``--ft-continue --ft-inject 2:5``, 8 steps): the survivors raise
     the typed error within 5 s of the kill, shrink to 4 ranks over 2
     workers on a cid of the FT band, restore step 4 bitwise, end with
     the degraded closed-form integer sum, bitwise equal parameters, a
     finite loss below step 0's and one failure and one recovery in the
     ``ft_*`` pvars; the revoked world's plans are gone and the capture
     lock is free. Job B (``--enable-recovery``, 2 restarts, ``--ft-inject
     2:3``, 6 steps): the replacement rejoins, ``recover("respawn")``
     rebuilds 6 ranks, the integer sum is the no-failure closed form,
     and steps 3 and 4's losses and parameter checksums are bitwise job
     A's; exactly one restart. Every job exits 0 and leaves no worker,
     segment or ring. Then per job and worker: kill -> typed error,
     ``ft_recovery_seconds``, ``steps_lost``, kill -> replacement
     rejoined and its cold start, ms per step before and after the
     recovery, launches and peak memory. ``python3 chip_smoke.py
     --slice13`` runs it alone (no result line);
   - slice 14, right after slice 13: the observability plane. A
     ``tools.tpurun`` job of 2 workers x 4 virtual ranks of ``cuda:0``
     (this script with ``--slice14-worker``) under ``obs_enable=1``,
     ``obs_sentinel=2`` (the inline contract check), the sampler pushing
     to the HNP every 0.25 s, ``btl_nativewire_events=1`` (the C event
     ring) and dump and postmortem directories. Once both workers are
     up the parent queries the live job with ``tpu_ps`` (both workers
     with pid, state and rss) and sends worker 1 a SIGUSR1 (its
     postmortem carries every contributor, the job goes on). Each
     worker: the spanning allreduce at 8 B, 256 KiB, 4 MiB and 256 MiB
     f32, interpreted then replayed from frozen wire plans, and the
     tuned allreduce on its shadow comm, every output bitwise its
     closed form and the same calls' output after ``obs.disable()``
     (check 1); a fresh signature fired interpreted then replayed,
     whose journal message spans and ledger record (expanded) agree by
     kind and count (check 7); one allreduce worker 1 reaches 2 s late;
     the full-width TpuLM (seed 0, flash): an eval forward and 2
     data-parallel AdamW steps at (1, 2048) Zipf tokens a rank through
     the tree pass, its loss and parameter checksum bitwise the same
     run after ``obs.disable()``; the replayed 256 KiB allreduce with
     the plane on and off, and 8 MiB shm-ring ping-pongs with the event
     ring installed and not, 7 interleaved turns each. The parent then
     holds the finalize dumps (``journal``, ``series``, ``ledger``,
     ``nativeev`` of both workers; check 2), merges them with
     ``tpu_doctor`` into one trace with cross-process and paired native
     fragment flows, finds worker 1 the slowest of the late round and
     the contracts aligned (check 3), the HNP's series pushes of both
     workers and each worker's TAG_CLOCK offset (check 4). A second
     job: worker 1 posts ``bcast`` where worker 0 posts ``allreduce``,
     both raise ERR_COLL_MISMATCH within the round naming the other
     process and both call sites, the next round matches; under
     ``obs_stall_timeout=1.5`` worker 1 sleeps 3 s and worker 0's
     watchdog dumps a postmortem naming the allreduce and worker 1's
     ranks (check 6). Every check is fatal; launches of
     ``stream_axpy[sum]`` and ``flash_*`` and the journal's spans by
     layer print per worker (check 7). Later, in this process: the 1
     MiB allreduce on 8 virtual ranks with the sentinel at 0 and at 1,
     and the one-card TpuLM train step with the plane off and on, 7
     turns each; the four ratios print beside their budgets.
     ``python3 chip_smoke.py --slice14`` runs it alone (no result
     line);
   - slice 15, right after slice 14: the service plane. One
     ``tpu-serviced`` daemon (``python -m
     ompi_release_tpu_torch.service.daemon``, a child process) and
     three ``tools.tpurun`` jobs of this script with
     ``--slice15-worker MODE`` on ``cuda:0``, all under
     ``wire_qos_classes=latency:8,bulk:2``; each job admits itself as a
     tenant and builds a comm on its tenant band's first cid, stamped
     with its class. The latency tenant (2 workers x 2 virtual ranks):
     200 256 KiB f32 allreduces a leg, alone, beside the bulk tenant
     under QoS and beside it with ``wire_qos_classes`` unset (FIFO),
     every output bitwise its closed form; then calls and lease
     renewals beside the kill job, and a clean release. The bulk tenant
     (2 x 2): 64 MiB f32 allreduces (the SUM kernel in hier's fold)
     through both of those legs, each bitwise its closed form, then
     the full-width TpuLM (seed 0, flash): an eval and 2 data-parallel
     AdamW steps on its tenant comm with QoS off and again on, losses
     and parameter checksums bitwise equal; worker 0 checkpoints and
     releases. The C executor's withdrawals under the arbiter are
     counted. The kill job (3 x 2): worker 0 serves a ``tpu_server``
     table the parent reads with ``tpu_doctor collect`` and ``tpu_top
     --metrics``; worker 2 SIGKILLs itself before its tenant comm's
     11th allreduce, the survivors get ERR_PROC_FAILED or ERR_REVOKED on
     the tenant-band cid and worker 0 reports the failure. The parent
     then renders ``tpu_top --tenants`` (both episodes), runs
     ``tpu_clean --dry-run``, ``tpu_checkpoint verify`` on the bulk
     tenant's checkpoint and ``tpu_info --json`` (which must name the
     card); no worker, ring or segment may outlive its job, and the
     daemon exits 0 on SIGINT. Later, in this process: ``tpu_tune
     --ops allreduce --sizes 1024,65536,1048576,16777216 --repeats 3``
     on 8 virtual ranks, its rule file loaded through
     ``coll_tuned_use_dynamic_rules`` and an allreduce at each size
     bitwise its closed form. Every check is fatal; per-worker
     launches, the latency legs' p50/p99, the isolation and FIFO
     ratios, the bulk tenant's ms and bus GB/s and the TpuLM step
     print. ``python3 chip_smoke.py --slice15`` runs it alone (no
     result line);
   - slice 16, right after slice 15: the distributed bootstrap, with no
     launcher. The ``unified_world_tpu`` example in two processes
     started by hand with ``OMPITPU_COORDINATOR`` /
     ``OMPITPU_PROCESS_ID`` / ``OMPITPU_NUM_PROCESSES`` (one job secret
     for both) must print both of its result lines; then two processes
     of this script (``--slice16-worker``), 4 virtual ranks each on
     ``cuda:0``, form an 8-rank WORLD (process 0 hosts the
     coordinator): the f32 allreduce at 8 B, 256 KiB, 16 MiB and 256
     MiB a rank, each bitwise its closed form, then 5 replays timed,
     the SUM kernel's launches counted per process; then bench.py's
     native_wire QoS leg (``bench.native_wire_qos_leg``, its two lines).
     No process may leave a ring or segment. The timings print beside
     slice 10's tpurun numbers of the same run. ``python3 chip_smoke.py
     --slice16`` runs it alone (no result line);
4. times the kernels (CUDA events, median of 7) at the main path's
   shapes beside their bound, their plain twins and one PyTorch library
   call, the streaming kernels, the transpose and the eager chain hop in
   turns with their twins and library calls (the chain hop eager and
   replayed from a CUDA graph; the flash forward beside
   ``scaled_dot_product_attention``, by CUDA events and by its device
   time in a profiler window, the two backward kernels beside SDPA's
   backward, timed only; the three streaming rows also in bf16 at the
   same bytes, the SUM also at 2^20, 2^22 and 2^24 f32 elements beside
   ``torch.add``; ``ring_fold`` at 8 ranks x 256 MiB in 1 MiB segments,
   f32 and bf16, beside its twin and the interpreted segmented ring it
   replaces), every wrapper's host µs per launch beside
   ``torch.add(x, 1)``'s (10,000 back-to-back calls at small shapes),
   and the tuned allreduce per size (time and bus bandwidth 2(n-1)/n *
   bytes / t); a torch.profiler window per size says where the
   allreduce's device time goes, one over an eval batch where the
   forward's goes and one over a train step where the step's goes (busy
   share, top kernels, host gaps); the forward's ms per batch and the
   train step's ms per step, tokens/s, TFLOP/s and MFU (closed-form
   FLOPs, ``models/flops.py``, against the card's bf16 peak) and peak
   memory; the MoE step likewise, with its profiler window and its
   one-hot einsums timed alone at the step's shapes; the Mixer's train
   step (ms, samples/s, peak memory, profiler window);
5. runs the port's bench suite (``ompi_release_tpu_torch.bench``, the
   five BASELINE configs) in-process and prints its lines, then the MFU
   line (``transformer_fwdbwd_step``), the headline
   ``op_sum_256MiB_f32_hbm_bw`` last among them.

``python3 chip_smoke.py --ring-fold`` builds the kernels and runs the
ring kernel's checks, its timing and its host cost alone (no result
line).

Any mismatch or failure raises (exit code != 0) before the last line;
no phase's failure is caught. The last
line is ``{"ok": true, "device": {...}}``. Without CUDA it exits 2 and
prints no result.
"""

import json
import math
import statistics
import subprocess
import sys
import time

from ompi_release_tpu_torch import bench as tbench

#: H100 SXM published HBM rate (bytes/s), the denominator of bound_ms
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM published dense peaks (flop/s): bf16 tensor cores, and f32
#: on the CUDA cores (the flash kernels' floor before the tensor cores)
BF16_FLOPS = 989e12
F32_CUDA_CORE_FLOPS = 67e12
N_RANKS = 8
MIB = 1 << 20
SOURCE = "ompi_release_tpu_torch/csrc/stream_ops.cu"
#: the entry flash_fwd and its f32 route (CUDA cores); its bf16 route on
#: the tensor cores (wgmma)
FLASH_SOURCE = "ompi_release_tpu_torch/csrc/flash_attn.cu"
FLASH_BF16_SOURCE = "ompi_release_tpu_torch/csrc/flash_attn_wgmma.cu"
#: the forward pallas_call of _flash_forward (body _attn_kernel :38)
FLASH_REPLACES = "ompi_release_tpu/ops/pallas_attention.py:114"
#: the main path's flash call: (B * H, S, D) bf16 causal
FLASH_SHAPE = (64, 2048, 64)
FLASH_BWD_SOURCE = "ompi_release_tpu_torch/csrc/flash_attn_bwd.cu"
#: the bf16 route of the two backward entries, on the tensor cores (wgmma)
FLASH_BWD_BF16_SOURCE = "ompi_release_tpu_torch/csrc/flash_attn_bwd_wgmma.cu"
#: the model's attention at head dim 128 (d_model 512 as 4 x 128 heads)
FLASH_SHAPE_D128 = (32, 2048, 128)
#: the trunk's bf16 products, (8 x 2048, d_model) x (d_model, F) and the
#: FFN's way back (ROADMAP queue 3 item 1)
TRUNK_PRODUCTS = (((16384, 512), (512, 512)), ((16384, 512), (512, 2048)),
                  ((16384, 2048), (2048, 512)))
#: the two backward pallas_calls of _flash_backward (bodies
#: _bwd_dq_kernel :140 and _bwd_dkv_kernel :185)
DQ_REPLACES = "ompi_release_tpu/ops/pallas_attention.py:264"
DKV_REPLACES = "ompi_release_tpu/ops/pallas_attention.py:283"
TRAIN_STEPS = 4  # slice 4's window: train steps on one fixed batch
MOE_EXPERTS = 4  # the repo's expert count (__graft_entry__.py:106)
MOE_TRAIN_STEPS = 3  # slice 5's MoE window: adamw(1e-3) steps
SDPA_BWD_CALLS = 5  # SDPA backward calls in its profiler window
SDPA_FWD_CALLS = 5  # calls per forward profiler window (SDPA, kernel)
KERNELS = {
    # wrapper -> (TPU kernel it replaces, streams moved per element); all
    # three Pallas bodies launch through _blocked_call's pallas_call
    # (pallas_op.py:79)
    "sum": ("ompi_release_tpu/ops/pallas_op.py:156", 3),   # _pallas_sum_fn
    "axpy": ("ompi_release_tpu/ops/pallas_op.py:93", 3),   # axpy
    "scale": ("ompi_release_tpu/ops/pallas_op.py:105", 2),  # scale
}
#: the transpose (make_transpose_loop) and chain (make_chain_loop)
#: pallas_calls
TRANSPOSE_REPLACES = "ompi_release_tpu/ops/pallas_op.py:300"
CHAIN_REPLACES = "ompi_release_tpu/ops/pallas_op.py:336"
TRANSPOSE_N = 8192  # alltoall_i32_torus's (n, n) int32
P2P_BYTES = 256 * MIB
HOPS_TIMED = 1000  # dependent chain hops per timing window
HOST_CALLS = 10000  # back-to-back calls per host-time window
#: the tuned ring allreduce's one kernel (coll/spmd.py selects it for a
#: SUM on the card); it replaces no Pallas kernel
RING_FOLD_SOURCE = "ompi_release_tpu_torch/csrc/ring_ops.cu"
RING_FOLD_REPLACES = ("none: the interpreted ring body, "
                      "ompi_release_tpu_torch/coll/spmd.py _ring_passes")
#: the large cell's top size, 256 MiB a rank over 8 ranks, in the tuned
#: segmented ring's 1 MiB segments
RING_FOLD_BYTES = 256 * MIB
RING_FOLD_SEG_BYTES = MIB
#: (body, elements a rank, segment parameter) of the ring kernel's
#: checks: the plain ring, the pipelined ring (segment count) and the
#: segmented ring (segment length), with lengths, chunks and segments
#: that are and are not multiples of a 16-byte vector, and fewer
#: elements than ranks
RING_FOLD_CASES = (("ring", 1, 0), ("ring", 37, 0), ("ring", 20, 0),
                   ("ring", 1 << 16, 0), ("pipelined", 1001, 3),
                   ("segmented", 1001, 100), ("segmented", 96, 6),
                   ("segmented", (1 << 18) + 8, 1 << 14))
#: the SUM's smaller operand sizes on the main path (f32 elements): one
#: below the streaming kernels' old capped grid (2,162,688) and two above
SUM_SIZES = (1 << 20, 1 << 22, 1 << 24)
GRAPH_CALLS = 10  # calls per window (eager) or per captured graph


def log(msg):
    print(msg, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


def sum_folds(cuda_op):
    """Launches of the kernels that add on the card: ``stream_axpy``'s
    SUM and ``ring_fold``, whose body folds the tuned ring allreduce's
    SUM."""
    return cuda_op.LAUNCHES["sum"] + cuda_op.LAUNCHES["ring_fold"]


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 \
        else f"nvidia-smi failed: {res.stderr.strip()}"


def bits_equal(a, b):
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}.get(
        a.element_size())
    return bool(torch.equal(a.view(view), b.view(view))) if view else \
        bool(torch.equal(a, b))


def bf16_ulp(x):
    """One bf16 ulp at each value of the f32 tensor ``x``."""
    import torch

    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def ulp_close(got, want, dtype, atol=0.0):
    """f32: rtol 1e-6; bf16: within one bf16 ulp of the plain twin (plus
    ``atol``)."""
    import torch

    got, want = got.float(), want.float()
    if dtype is torch.float32:
        return bool(torch.allclose(got, want, rtol=1e-6, atol=0))
    return bool(((got - want).abs() <= bf16_ulp(want) + atol).all())


def time_ms(fn, reps=7, inner=1, warmup=2):
    """Median ms per call of ``fn`` over ``reps`` CUDA-event windows of
    ``inner`` calls each, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(inner):
            fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / inner)
    return statistics.median(times)


def turns_ms(fns, reps=7, inner=1):
    """{name: median ms per call} of each function of ``fns``: one
    CUDA-event window of ``inner`` calls per function per round, the
    functions taken in turns (the order reversed every other round, after
    a warm-up round) so that a drift of the card's or the host's speed
    falls on all of them alike."""
    import torch

    times = {name: [] for name in fns}
    for r in range(reps + 1):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            if r == 0:
                fns[name]()
                continue
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(inner):
                fns[name]()
            t1.record()
            t1.synchronize()
            times[name].append(t0.elapsed_time(t1) / inner)
    return {name: statistics.median(t) for name, t in times.items()}


def streaming_bitwise(cuda_op, a, b, what):
    """``sum_``, ``axpy`` and ``scale`` on ``a`` (and ``b``) against their
    plain twins, bitwise: the same f32 operations rounded once."""
    for name, got, want in (
            ("sum", cuda_op.sum_(a, b), cuda_op._plain_sum(a, b)),
            ("axpy", cuda_op.axpy(a, b, 0.999),
             cuda_op._plain_axpy(a, b, 0.999)),
            ("scale", cuda_op.scale(a, 1.0001),
             cuda_op._plain_scale(a, 1.0001))):
        check(bits_equal(got, want),
              f"{name} kernel != plain, bitwise ({what})")


def phase_kernels(cuda_op, torch, dev):
    """Each kernel against its plain twin at the contract's sizes."""
    for dtype in (torch.float32, torch.bfloat16):
        for n, off in ((1, 0), (4097, 0), ((1 << 26) + 3, 0), (4097, 1)):
            g = torch.Generator(device=dev).manual_seed(n + off)
            base = torch.randn(2, n + off, generator=g, device=dev).to(dtype)
            a, b = base[0, off:], base[1, off:]
            what = f"{dtype} n={n} offset={off}"
            streaming_bitwise(cuda_op, a, b, what)
            del base, a, b
        itemsize = torch.empty((), dtype=dtype).element_size()
        for n in cuda_op.stream_boundary_sizes(itemsize):
            for off in (0, 1):
                g = torch.Generator(device=dev).manual_seed(n + off)
                base = torch.randn(2, n + off, generator=g, device=dev).to(
                    dtype)
                streaming_bitwise(cuda_op, base[0, off:], base[1, off:],
                                  f"{dtype} n={n} offset={off}")
                del base
    for shape, dtype in (((TRANSPOSE_N, TRANSPOSE_N), torch.int32),
                         ((4097, 1000), torch.float32), ((1, 1), torch.float32)):
        g = torch.Generator(device=dev).manual_seed(shape[0])
        x = torch.randint(-2**31, 2**31 - 1, shape, generator=g, device=dev,
                          dtype=torch.int32).view(dtype)  # every bit pattern
        check(bits_equal(cuda_op.transpose(x), cuda_op._plain_transpose(x)),
              f"transpose kernel != x.t().contiguous() ({shape} {dtype})")
        del x
    x = torch.randn(cuda_op.CHAIN_TILE, device=dev)
    check(bits_equal(cuda_op.chain_hop(x), cuda_op._plain_chain_hop(x)),
          "chain hop kernel != x + 1")
    torch.cuda.synchronize()
    log("phase 2: kernels match their plain twins (f32/bf16; sum, axpy "
        "and scale bitwise at n=1, 4097, 2^26+3, offset 1, and around their "
        "partition's vector, its block and a grid of many blocks, aligned "
        "and offset 1; transpose "
        "(8192, 8192) int32, (4097, 1000) f32, (1, 1) bitwise; chain hop "
        "bitwise)")


def ptxas_report(cuda_op, lib):
    """Phase 1: each kernel's registers, static shared memory and spills
    from the build's ptxas ``-v`` report, and the flash kernel's dynamic
    shared memory (ptxas cannot see it)."""
    import re

    with open(cuda_op.ptxas_log_path(lib)) as fh:
        text = fh.read()
    kernel, spill = None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = [int(m.group(1)), int(m.group(2))]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            smem = re.search(r"(\d+) bytes smem", line)
            log(json.dumps({"ptxas_kernel": kernel,
                            "registers": int(m.group(1)),
                            "static_smem_bytes": int(smem.group(1))
                            if smem else 0,
                            "spill_stores_loads_bytes": spill}))
            kernel, spill = None, None
    load = cuda_op._load()
    log(json.dumps({"flash_dynamic_smem_bytes": {
        name: {d: int(getattr(load, f"{name}_smem_bytes")(d))
               for d in (8, 64, 128)}
        for name in ("flash_fwd", "flash_fwd_bf16", "flash_bwd_dq",
                     "flash_bwd_dkv", "flash_bwd_dq_bf16",
                     "flash_bwd_dkv_bf16")}}))


def sass_report(cuda_op, lib):
    """Phase 1: per flash kernel of the built library, its count of
    tensor-core (``HGMMA``) and atomic (``ATOM*``, ``RED``) instructions
    from ``cuobjdump -sass``. Each instantiation of the bf16 forward and
    the two bf16 backward kernels must hold HGMMA and no atomic. Returns
    {wrapper: {padded head dim: HGMMA count}} for those three."""
    import os
    import re

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    res = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=300)
    check(res.returncode == 0, f"cuobjdump -sass failed: {res.stderr}")
    counts, fn = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {"HGMMA": 0, "atomic": 0}
        elif fn:
            counts[fn]["HGMMA"] += bool(re.search(r"\bHGMMA\b", line))
            counts[fn]["atomic"] += bool(re.search(r"\b(ATOM\w*|RED)\b",
                                                   line))
    hgmma = {}
    for name, wrapper in (("flash_fwd_wgmma", "flash_fwd"),
                          ("flash_bwd_dq_wgmma", "flash_bwd_dq"),
                          ("flash_bwd_dkv_wgmma", "flash_bwd_dkv")):
        for dp in (64, 128):
            found = [c for f, c in counts.items()
                     if f"{name}ILi{dp}E" in f]
            check(len(found) == 1, f"{name}<{dp}> not in the library's SASS")
            check(found[0]["HGMMA"] > 0, f"{name}<{dp}> has no HGMMA")
            check(found[0]["atomic"] == 0, f"{name}<{dp}> has atomics")
            hgmma.setdefault(wrapper, {})[dp] = found[0]["HGMMA"]
    log(json.dumps({"sass_flash_kernels": {
        f: c for f, c in counts.items() if "flash" in f}}))
    log(f"phase 1: HGMMA per bf16 flash kernel {hgmma}; no atomics")
    return hgmma


def check_bf16_reduction(torch, dev):
    """ROADMAP queue 3 item 1: does cuBLAS reduce bf16 products in bf16?
    ``column_parallel`` at the trunk's shapes with
    ``allow_bf16_reduced_precision_reduction`` on and off, each against
    the f32 product rounded once to bf16; logged, not gated."""
    from ompi_release_tpu_torch.parallel.tp import column_parallel

    flags = torch.backends.cuda.matmul
    saved = flags.allow_bf16_reduced_precision_reduction
    g = torch.Generator(device=dev).manual_seed(12)
    out = []
    try:
        for xs, ws in TRUNK_PRODUCTS:
            x = torch.randn(*xs, generator=g, device=dev).to(torch.bfloat16)
            w = (torch.randn(*ws, generator=g, device=dev)
                 * xs[1] ** -0.5).to(torch.bfloat16)
            want = (x.float() @ w.float()).to(torch.bfloat16).float()
            row = {"x": list(xs), "w": list(ws)}
            got = {}
            for on in (True, False):
                flags.allow_bf16_reduced_precision_reduction = on
                got[on] = column_parallel(x, w).float()
                diff = (got[on] - want).abs()
                beyond = diff > bf16_ulp(want)
                row["on" if on else "off"] = {
                    "max_abs_diff": float(diff.max()),
                    "elements_differing": int((diff > 0).sum()),
                    "beyond_one_ulp": int(beyond.sum()),
                    "max_abs_value_there": float(want.abs()[beyond].max())
                    if bool(beyond.any()) else None}
            row["on_equals_off"] = bool(torch.equal(got[True], got[False]))
            out.append(row)
    finally:
        flags.allow_bf16_reduced_precision_reduction = saved
    log(json.dumps({"bf16_reduced_precision_reduction": out,
                    "default": saved}))


def flash_close(torch, got, want, got_lse, want_lse):
    """out: f32 rtol/atol 2e-5; bf16 within one bf16 ulp plus the f32
    atol 2e-5 (each side rounds its own f32 result once, and near zero
    the two f32 sums differ by more than a bf16 ulp of the value);
    lse atol 1e-5."""
    ok = bool(torch.allclose(got, want, rtol=2e-5, atol=2e-5)) \
        if got.dtype is torch.float32 else \
        ulp_close(got, want, got.dtype, atol=2e-5)
    return ok and bool(torch.allclose(got_lse, want_lse, rtol=0, atol=1e-5))


def phase_flash(fa, torch, dev):
    """The flash forward against its plain twin at the contract's cases,
    at the model's shape in 64- and 128-wide heads and with the bf16
    kernel's element loads."""
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            for s in (1, 100, 129, 2048):
                for d in (8, 64, 128):
                    g = torch.Generator(device=dev).manual_seed(s * 1000 + d)
                    q, k, v = (torch.randn(3, s, d, generator=g, device=dev)
                               .to(dtype) for _ in range(3))
                    out, lse = fa.flash_forward(q, k, v, causal)
                    want, want_lse = fa._plain_flash_forward(q, k, v, causal)
                    check(flash_close(torch, out, want, lse, want_lse),
                          f"flash_fwd != plain twin ({dtype} causal={causal}"
                          f" S={s} D={d})")
                    n_cases += 1
    g = torch.Generator(device=dev).manual_seed(64)
    q, k, v = (torch.randn(*FLASH_SHAPE, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    out, lse = fa.flash_forward(q, k, v, True)
    want, want_lse = fa._plain_flash_forward(q, k, v, True)
    check(flash_close(torch, out, want, lse, want_lse),
          f"flash_fwd != plain twin at the model's {FLASH_SHAPE} bf16 causal")
    diff = (out.float() - want.float()).abs()
    beyond = diff > bf16_ulp(want.float())
    log(json.dumps({"flash_bf16_model_shape": {
        "max_abs_err": float(diff.max()),
        "beyond_one_ulp": int(beyond.sum()),
        "max_abs_value_there": float(want.float().abs()[beyond].max())
        if bool(beyond.any()) else None,
        "lse_max_abs_err": float((lse - want_lse).abs().max())}}))
    g = torch.Generator(device=dev).manual_seed(128)
    q, k, v = (torch.randn(*FLASH_SHAPE_D128, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    out, lse = fa.flash_forward(q, k, v, True)
    want, want_lse = fa._plain_flash_forward(q, k, v, True)
    check(flash_close(torch, out, want, lse, want_lse),
          f"flash_fwd != plain twin at {FLASH_SHAPE_D128} bf16 causal")
    log(json.dumps({"flash_bf16_d128": {
        "max_abs_err": float((out.float() - want.float()).abs().max()),
        "lse_max_abs_err": float((lse - want_lse).abs().max())}}))
    # 16-byte copies need D % 8 == 0 and 16-byte aligned operands: D 20
    # and views at element offset 1 take the element loads, 72 the DP 128
    # instance
    for d, off in ((20, 0), (72, 0), (64, 1)):
        g = torch.Generator(device=dev).manual_seed(d + off)
        n = 2 * 100 * d
        q, k, v = (torch.randn(n + off, generator=g, device=dev)
                   .to(torch.bfloat16)[off:].view(2, 100, d)
                   for _ in range(3))
        out, lse = fa.flash_forward(q, k, v, True)
        want, want_lse = fa._plain_flash_forward(q, k, v, True)
        check(flash_close(torch, out, want, lse, want_lse),
              f"flash_fwd != plain twin with element loads (D={d} "
              f"offset={off})")
    torch.cuda.synchronize()
    log(f"phase 2: flash_fwd matches its plain twin on {n_cases} cases "
        f"(causal and not; S 1, 100, 129, 2048; D 8, 64, 128; f32, bf16), "
        f"at {FLASH_SHAPE} and {FLASH_SHAPE_D128} bf16 causal and with "
        "element loads (D 20, 72; offset 1)")


def grads_close(torch, got, want):
    """f32 rtol/atol 2e-4; bf16 within one bf16 ulp plus 2e-4."""
    for a, b in zip(got, want):
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.dtype is torch.float32:
            ok = bool(torch.allclose(a, b, rtol=2e-4, atol=2e-4))
        else:
            ok = ulp_close(a, b, a.dtype, atol=2e-4)
        if not ok:
            return False
    return True


def bwd_pair(fa, q, k, v, do, causal):
    """(kernels, plain twins) of the backward at q, k, v with cotangent
    do: each kernel against its own twin, on the same lse and delta."""
    out, lse = fa.flash_forward(q, k, v, causal)
    args = (q, k, v, lse, do, fa._delta(out, do), causal)
    return ((fa._bwd_dq_kernel(*args), *fa._bwd_dkv_kernel(*args)),
            (fa._plain_bwd_dq(*args), *fa._plain_bwd_dkv(*args)))


def phase_flash_bwd(fa, torch, dev):
    """The two backward kernels against their plain twins at the
    contract's cases, and the whole backward at the model's shape, run
    twice: bitwise equal."""
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            for s in (1, 100, 129, 256):
                for d in (8, 64, 128):
                    g = torch.Generator(device=dev).manual_seed(s * 1000 + d)
                    q, k, v, do = (torch.randn(3, s, d, generator=g,
                                               device=dev).to(dtype)
                                   for _ in range(4))
                    got, want = bwd_pair(fa, q, k, v, do, causal)
                    check(grads_close(torch, got, want),
                          f"flash backward kernels != plain twins ({dtype} "
                          f"causal={causal} S={s} D={d})")
                    n_cases += 1
    g = torch.Generator(device=dev).manual_seed(65)
    q, k, v, do = (torch.randn(*FLASH_SHAPE, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    got, want = bwd_pair(fa, q, k, v, do, True)
    check(grads_close(torch, got, want), "flash backward kernels != plain "
          f"twins at the model's {FLASH_SHAPE} bf16 causal")
    out, lse = fa.flash_forward(q, k, v, True)
    first = fa.flash_backward(q, k, v, out, lse, do, True)
    again = fa.flash_backward(q, k, v, out, lse, do, True)
    check(all(bits_equal(a, b) for a, b in zip(first, again)),
          "two runs of the flash backward differ")
    check(all(bits_equal(a, b) for a, b in zip(first, got)),
          "flash_backward != its two kernels")
    stats = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        diff = (a.float() - b.float()).abs()
        beyond = diff > bf16_ulp(b.float())
        stats[name] = {
            "max_abs_err": float(diff.max()),
            "max_abs_value": float(b.float().abs().max()),
            "beyond_one_ulp": int(beyond.sum()),
            "max_abs_value_there": float(b.float().abs()[beyond].max())
            if bool(beyond.any()) else None}
    log(json.dumps({"flash_bwd_bf16_model_shape": stats}))
    g = torch.Generator(device=dev).manual_seed(66)
    q, k, v, do = (torch.randn(*FLASH_SHAPE_D128, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    got, want = bwd_pair(fa, q, k, v, do, True)
    check(grads_close(torch, got, want), "flash backward kernels != plain "
          f"twins at {FLASH_SHAPE_D128} bf16 causal")
    log(json.dumps({"flash_bwd_bf16_d128": {
        name: float((a.float() - b.float()).abs().max())
        for name, a, b in zip(("dq", "dk", "dv"), got, want)}}))
    torch.cuda.synchronize()
    log(f"phase 2: flash_bwd_dq and flash_bwd_dkv match their plain twins "
        f"on {n_cases} cases (causal and not; S 1, 100, 129, 256; D 8, 64, "
        f"128; f32, bf16) and at {FLASH_SHAPE} and {FLASH_SHAPE_D128} bf16 "
        "causal; two runs of the backward are bitwise equal")


def drive_main_path(mpi, tmvar, torch, dev):
    """The user path: returns every input and output for the checks."""
    world = mpi.init(cli_args=["--mca", "runtime_virtual_ranks",
                               str(N_RANKS)])
    check(world.size == N_RANKS and world.device == dev,
          f"WORLD is {world.size} ranks on {world.device}")
    tmvar.set_value("coll", "tuned")
    try:
        tuned = world.dup(name="tuned")
    finally:
        tmvar.VARS.unset("coll")
    g = torch.Generator(device=dev).manual_seed(1234)
    runs = []  # (comm, method, input, kwargs, output)

    def run(comm, method, x, **kw):
        runs.append((comm, method, x, kw, getattr(comm, method)(x, **kw)))

    for nbytes in (8, 4 << 10, 64 << 10, 4 * MIB, 16 * MIB, 256 * MIB):
        count = nbytes // 4
        run(tuned, "allreduce",
            torch.randn(N_RANKS, count, generator=g, device=dev))
        run(tuned, "allreduce", torch.ones(N_RANKS, count, device=dev))
    ints = lambda shape: torch.randint(  # noqa: E731  exact in any order
        -64, 64, shape, generator=g, device=dev).float()
    run(tuned, "reduce_scatter_block", ints((N_RANKS, 32 * MIB)))
    run(tuned, "bcast", torch.randn(N_RANKS, 64 * MIB, generator=g,
                                    device=dev), root=3)
    run(tuned, "allgather", torch.randn(
        N_RANKS, 16 * MIB, generator=g, device=dev).to(torch.bfloat16))
    run(tuned, "alltoall", torch.randint(
        -2**31, 2**31 - 1, (N_RANKS, 8 * MIB), generator=g, device=dev,
        dtype=torch.int32))
    run(world, "allreduce", ints((N_RANKS, 16 * MIB)))
    tuned.barrier()
    world.barrier()
    return world, tuned, runs


def drive_bench_loops(cuda_op, torch, dev):
    rows = cols = 8192  # 2^26 elements: 256 MiB f32
    a = torch.rand(rows, cols, device=dev)
    axpy_sum = cuda_op.make_axpy_loop(rows, cols)(a, 4)
    scale_sum = cuda_op.make_scale_loop(rows, cols)(a, 4)
    torch.cuda.synchronize()
    return a, float(axpy_sum), float(scale_sum)


def drive_p2p_path(world, cuda_op, torch, dev):
    """Slice 2's path on the WORLD of 8 virtual ranks: the ring example,
    a pipelined 256 MiB send, the static p2p schedules and the
    transpose/chain loops. Returns what the checks need."""
    from ompi_release_tpu_torch.examples import ring_tpu
    from ompi_release_tpu_torch.mca import pvar as tpvar
    from ompi_release_tpu_torch.p2p import spmd as p2p_spmd

    out = {"ring": ring_tpu.ring(world)}
    g = torch.Generator(device=dev).manual_seed(5)
    pipelined = tpvar.PVARS.lookup("pml_pipelined_sends")
    before = pipelined.read()
    payload = torch.randn(P2P_BYTES // 4, generator=g, device=dev)
    world.send(payload, dest=5, tag=42, rank=0)
    got, st = world.recv(source=0, tag=42, rank=5)
    out["send"] = (payload, got, st, pipelined.read() - before)
    x = torch.randn(N_RANKS, 4096, generator=g, device=dev)
    out["static"] = (x, p2p_spmd.ring_shift(x, 3),
                     p2p_spmd.sendrecv(x, [(0, 7), (2, 1)]),
                     p2p_spmd.halo_exchange(x))
    out["sendrecv"] = world.sendrecv(
        [x[r] for r in range(N_RANKS)],
        [(r + 1) % N_RANKS for r in range(N_RANKS)], sendtag=9,
        sources=[(r - 1) % N_RANKS for r in range(N_RANKS)], recvtag=9)
    n = TRANSPOSE_N
    a = torch.randint(-2**20, 2**20, (n, n), generator=g, device=dev,
                      dtype=torch.int32)
    t_loop, _ = cuda_op.make_transpose_loop(n)
    af = a[:8, :128].float().contiguous()
    k_graph = 2 * cuda_op.GRAPH_BLOCK + 3
    out["loops"] = (a, int(t_loop(a, 2)), af,
                    float(cuda_op.make_chain_loop(4)(af, 25)),
                    float(cuda_op.make_chain_loop(4, graph=True)(af, k_graph)),
                    k_graph)
    torch.cuda.synchronize()
    return out


def check_p2p_path(torch, out):
    passes, last = out["ring"]
    n, laps = 4, 3  # ring_tpu: the first 4 ranks, LAPS laps
    check((passes, last) == ((n - 1) + laps * n, 0),
          f"ring example: {passes} passes, final {last}")
    payload, got, st, pipelined = out["send"]
    check(bits_equal(got, payload), "256 MiB send/recv != payload")
    check((st.source, st.tag, st.count) == (0, 42, payload.numel()),
          f"256 MiB recv status {st}")
    check(pipelined == 1, f"256 MiB send took {pipelined} pipelined moves")
    x, shifted, sparse, (from_left, from_right) = out["static"]
    idx = lambda rows: torch.tensor(rows, device=x.device)  # noqa: E731
    check(bits_equal(shifted, x[idx([(r - 3) % N_RANKS
                                     for r in range(N_RANKS)])]),
          "ring_shift != x[(r - 3) % n]")
    want = torch.zeros_like(x)
    want[7], want[1] = x[0], x[2]
    check(bits_equal(sparse, want), "sendrecv schedule != its closed form")
    want_l, want_r = torch.zeros_like(x), torch.zeros_like(x)
    want_l[1:], want_r[:-1] = x[:-1], x[1:]
    check(bits_equal(from_left, want_l) and bits_equal(from_right, want_r),
          "halo_exchange != shifted rows with zero boundaries")
    values, statuses = out["sendrecv"]
    for r in range(N_RANKS):
        check(bits_equal(values[r], x[(r - 1) % N_RANKS])
              and statuses[r].source == (r - 1) % N_RANKS,
              f"PML sendrecv at rank {r}")
    a, t_sum, af, eager_sum, graph_sum, k_graph = out["loops"]
    check(t_sum == int(a[0, 0]) + int(a[-1, -1]),
          "transpose loop checksum != a[0, 0] + a[-1, -1]")
    base = float(af[0, 0]) + float(af[-1, -1])
    check(eager_sum == base + 2 * 4 * 25, "eager chain loop checksum")
    check(graph_sum == base + 2 * 4 * k_graph, "graph chain loop checksum")
    log("phase 3: ring example (15 passes, final 0), pipelined 256 MiB "
        "send, static schedules, PML sendrecv and the transpose/chain "
        "loop checksums match their closed forms")


def drive_model_path():
    """Slice 3's path: the full-width TpuLM eval forward, 3 batches of
    (8, 2048) through ``make_forward`` with ``attn_impl="auto"`` (the
    model's forward), bf16, on cuda:0. Returns the model and the
    (loss, ms) of each batch."""
    from ompi_release_tpu_torch import entry as tentry
    from ompi_release_tpu_torch.models.transformer import ModelConfig, TpuLM

    model = TpuLM(ModelConfig(), seed=0)
    return model, tentry.run_eval(model)


def check_model_path(torch, model, evals, flash_launches):
    """The 3 losses, then the first batch again through ring attention
    (bf16) and through both paths in f32."""
    import dataclasses
    import math

    from ompi_release_tpu_torch import entry as tentry
    from ompi_release_tpu_torch.models.transformer import make_forward

    cfg = model.cfg
    want = cfg.n_layers * tentry.EVAL_BATCHES
    check(flash_launches == want,
          f"flash_fwd launched {flash_launches} times over "
          f"{tentry.EVAL_BATCHES} batches of {cfg.n_layers} layers, "
          f"not {want}: attn_impl='auto' must take the kernel on the card")
    for i, (loss, _) in enumerate(evals):
        check(math.isfinite(loss) and abs(loss - math.log(cfg.vocab)) < 1.0,
              f"eval batch {i}: loss {loss} not within 1.0 of "
              f"ln({cfg.vocab}) = {math.log(cfg.vocab):.4f}")
    tokens, targets = tentry._batch(cfg, tentry.EVAL_BATCH, tentry.EVAL_SEQ)
    params = model.params()
    ring = float(make_forward(dataclasses.replace(cfg, attn_impl="ring"),
                              model.mesh)(params, tokens, targets))
    flash = evals[0][0]
    check(abs(ring - flash) <= 1e-2 * abs(ring),
          f"bf16 loss: flash {flash} vs ring {ring} (rel 1e-2)")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = {n: t.float() for n, t in params.items() if n != "layers"}
    p32["layers"] = {n: t.float() for n, t in params["layers"].items()}
    losses32 = {impl: float(make_forward(
        dataclasses.replace(cfg32, attn_impl=impl), model.mesh)(
            p32, tokens, targets)) for impl in ("flash", "ring")}
    check(abs(losses32["flash"] - losses32["ring"])
          <= 1e-4 * abs(losses32["ring"]),
          f"f32 loss: flash {losses32['flash']} vs ring "
          f"{losses32['ring']} (rel 1e-4)")
    torch.cuda.synchronize()
    log(json.dumps({"eval_losses": [ls for ls, _ in evals],
                    "ln_vocab": math.log(cfg.vocab), "ring_bf16": ring,
                    "f32": losses32}))
    log(f"phase 3: slice-3 eval forward: {flash_launches} flash launches "
        f"over {tentry.EVAL_BATCHES} batches; losses within 1.0 of "
        "ln(32000); flash == ring (bf16 rel 1e-2, f32 rel 1e-4)")


def drive_train_path():
    """Slice 4's path: the full-width TpuLM train step, TRAIN_STEPS steps
    of ``TpuLM.train_step`` (``adamw(1e-3)``, ``attn_impl="auto"``) on
    one fixed (8, 2048) batch, bf16, on cuda:0. Returns the model and the
    (loss, ms) of each step."""
    from ompi_release_tpu_torch import entry as tentry
    from ompi_release_tpu_torch.models.transformer import ModelConfig, TpuLM

    model = TpuLM(ModelConfig(), seed=0)
    return model, tentry.run_train(model, TRAIN_STEPS)


def check_train_path(torch, model, steps, launches):
    """The launches and losses of the window, then one step's loss and
    gradients from the state it left, through the kernels and through
    ring attention."""
    import dataclasses
    import math

    from ompi_release_tpu_torch import entry as tentry
    from ompi_release_tpu_torch.models.transformer import forward_loss
    from ompi_release_tpu_torch.optim import leaves

    cfg = model.cfg
    want = cfg.n_layers * TRAIN_STEPS
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[name] == want,
              f"{name} launched {launches[name]} times over {TRAIN_STEPS} "
              f"train steps of {cfg.n_layers} layers, not {want}")
    losses = [loss for loss, _ in steps]
    check(all(math.isfinite(x) for x in losses), f"train losses {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    tokens, targets = tentry._batch(cfg, tentry.EVAL_BATCH, tentry.EVAL_SEQ)
    tok = torch.as_tensor(tokens, device=model.device)
    tgt = torch.as_tensor(targets, device=model.device)
    params = model.params()
    names = [n for n in sorted(params) if n != "layers"]
    names = sorted(names + [f"layers/{n}" for n in params["layers"]])
    ts = leaves(params)
    got = {}
    for impl in ("flash", "ring"):
        loss = forward_loss(dataclasses.replace(cfg, attn_impl=impl), params,
                            tok, tgt)
        got[impl] = (float(loss.detach()), torch.autograd.grad(loss, ts))
        del loss
        torch.cuda.empty_cache()
    (lf, gf), (lr, gr) = got["flash"], got["ring"]
    check(abs(lf - lr) <= 1e-2 * abs(lr),
          f"train-step loss: flash {lf} vs ring {lr} (rel 1e-2)")
    rel = {n: float((a.float() - b.float()).norm() / b.float().norm())
           for n, a, b in zip(names, gf, gr)}
    for n, r in rel.items():
        check(r <= 3e-2, f"gradient of {n}: flash vs ring relative L2 "
                         f"error {r} > 3e-2")
    torch.cuda.synchronize()
    log(json.dumps({"train_losses": losses, "flash_vs_ring_loss": [lf, lr],
                    "grad_rel_l2_flash_vs_ring": rel}))
    log(f"phase 3: slice-4 train step: {launches['flash_fwd']} / "
        f"{launches['flash_bwd_dq']} / {launches['flash_bwd_dkv']} flash "
        f"fwd / dq / dkv launches over {TRAIN_STEPS} steps; losses finite and "
        "falling; flash == ring (loss rel 1e-2, gradients rel L2 3e-2)")


def drive_moe_path():
    """Slice 5's MoE path: the full-width switch-MoE TpuLM (``ModelConfig(
    n_experts=MOE_EXPERTS)``, capacity factor 1.25, bf16, seed 0), one
    eval batch of (8, 2048) and MOE_TRAIN_STEPS ``adamw(1e-3)`` steps on
    one fixed batch, on cuda:0. Returns the model, the eval's and the
    steps' (loss, ms)."""
    from ompi_release_tpu_torch import entry as tentry
    from ompi_release_tpu_torch.models.transformer import ModelConfig, TpuLM

    model = TpuLM(ModelConfig(n_experts=MOE_EXPERTS), seed=0)
    evals = tentry.run_eval(model, n_batches=1)
    return model, evals, tentry.run_train(model, MOE_TRAIN_STEPS)


def check_moe_path(torch, model, evals, steps, launches):
    """The MoE window's flash launches (8 per forward, 8 + 8 per
    backward) and losses: within 1.0 of ln(vocab) at init, finite and
    falling over the steps."""
    import math

    cfg = model.cfg
    want = {"flash_fwd": cfg.n_layers * (len(evals) + len(steps)),
            "flash_bwd_dq": cfg.n_layers * len(steps),
            "flash_bwd_dkv": cfg.n_layers * len(steps)}
    for name, n in want.items():
        check(launches[name] == n, f"MoE path: {name} launched "
                                   f"{launches[name]} times, not {n}")
    losses = [loss for loss, _ in evals + steps]
    check(all(math.isfinite(x) for x in losses), f"MoE losses {losses}")
    check(abs(losses[0] - math.log(cfg.vocab)) < 1.0,
          f"MoE eval loss {losses[0]} not within 1.0 of ln({cfg.vocab})")
    check(steps[-1][0] < steps[0][0], f"MoE train loss did not fall: "
                                      f"{losses}")
    log(json.dumps({"moe_eval_loss": evals[0][0],
                    "moe_train_losses": [x for x, _ in steps]}))
    log(f"phase 3: slice-5 MoE path: {want} flash launches; losses finite, "
        "within 1.0 of ln(32000), falling")


def check_moe_layer(torch, dev):
    """``moe_layer`` at full width (T = 8 x 2048 tokens, d 512, 4 experts,
    d_ff 2048, capacity factor 1.25, bf16) against an independent
    gather-based reference: each expert's kept tokens in queue order
    (the first C by token index), ``gate * expert(rows)``, dropped tokens
    0 (some must be dropped). The expert's input must equal the gathered
    rows bitwise, the output within one bf16 ulp plus 1e-5."""
    from ompi_release_tpu_torch.models.transformer import _expert_fn
    from ompi_release_tpu_torch.parallel import ep

    t, d, e, f = 8 * 2048, 512, MOE_EXPERTS, 2048
    g = torch.Generator(device=dev).manual_seed(21)
    # inputs off zero mean: the router then favours some experts, and
    # tokens over capacity are dropped
    x = (torch.randn(t, d, generator=g, device=dev) + 1).to(torch.bfloat16)
    router = (torch.randn(d, e, generator=g, device=dev) * 0.02).to(
        torch.bfloat16).float()
    we1 = (torch.randn(e, d, f, generator=g, device=dev) / d ** 0.5).to(
        torch.bfloat16)
    we2 = (torch.randn(e, f, d, generator=g, device=dev) / f ** 0.5).to(
        torch.bfloat16)
    seen = []

    def expert(pe, rows):
        seen.append(rows)
        return _expert_fn(pe, rows)

    with torch.no_grad():
        out, aux = ep.moe_layer(x, router, expert, (we1, we2),
                                capacity_factor=1.25)
        cap = max(1, int(1.25 * t / e))
        probs = torch.softmax(x.float() @ router, dim=-1)
        gate, choice = probs.max(dim=-1)
        want = torch.zeros(t, d, device=dev)
        kept_total = 0
        for i in range(e):
            kept = (choice == i).nonzero()[:, 0][:cap]  # queue order
            kept_total += kept.numel()
            rows = torch.zeros(cap, d, dtype=x.dtype, device=dev)
            rows[:kept.numel()] = x[kept]
            check(bits_equal(seen[i], rows),
                  f"moe_layer: expert {i}'s queue != the gathered rows")
            y = _expert_fn((we1[i], we2[i]), rows)[:kept.numel()]
            want[kept] = gate[kept, None] * y.float()
        want = want.to(x.dtype)
    check(0 < t - kept_total, "moe_layer check: no token dropped at 1.25")
    ok = ulp_close(out, want, torch.bfloat16, atol=1e-5)
    err = float((out.float() - want.float()).abs().max())
    check(ok, f"moe_layer != gather reference (max |diff| {err})")
    check(bool(torch.isfinite(aux)), f"moe_layer aux {aux}")
    log(json.dumps({"moe_layer_vs_gather": {
        "tokens": t, "capacity": cap, "dropped": t - kept_total,
        "max_abs_err": err, "aux": float(aux)}}))
    log("phase 3: moe_layer at (16384, 512) bf16 == the gather reference "
        "(queues bitwise, output within one bf16 ulp + 1e-5)")


def copy_params(params, device):
    """A copy of the (nested) parameter dict on ``device``, detached."""
    return {n: copy_params(t, device) if isinstance(t, dict)
            else t.detach().to(device, copy=True) for n, t in params.items()}


def check_moe_tiny_vs_cpu(torch, dev):
    """The tiny MoE config (``tests/test_models.py``'s CFG with 4 experts,
    capacity factor 1.25, f32, ``attn_impl="flash"``: the kernels on the
    card, their plain twins on the CPU): loss rel 1e-5 and every
    gradient within a relative L2 error of 2e-4 of the CPU's."""
    from ompi_release_tpu_torch.models import transformer as tfm
    from ompi_release_tpu_torch.optim import leaves

    cfg = tfm.ModelConfig(vocab=32, d_model=16, n_layers=2, n_heads=4,
                          head_dim=4, d_ff=32, max_seq=16, n_experts=4,
                          dtype=torch.float32, attn_impl="flash")
    base = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (8, 16),
                           generator=torch.Generator().manual_seed(0))

    def run(device):
        params = copy_params(base, device)
        ts = leaves(params)
        for p in ts:
            p.requires_grad_(True)
        tok = tokens.to(device)
        loss = tfm.forward_loss(cfg, params, tok, torch.roll(tok, -1, 1))
        return float(loss.detach()), [
            gr.cpu() for gr in torch.autograd.grad(loss, ts)]

    (lc, gc), (lg, gg) = run(torch.device("cpu")), run(dev)
    check(abs(lg - lc) <= 1e-5 * abs(lc),
          f"tiny MoE loss: card {lg} vs CPU {lc} (rel 1e-5)")
    rel = [float((a - b).norm() / b.norm()) for a, b in zip(gg, gc)]
    check(max(rel) <= 2e-4, f"tiny MoE gradients: card vs CPU relative L2 "
                            f"{rel} (> 2e-4)")
    log(f"phase 3: tiny MoE on the card == on the CPU (loss {lg} vs {lc}; "
        f"gradients rel L2 <= {max(rel):.2e})")


def check_mixer_vs_cpu(torch, dev):
    """The full-width Mixer step (``MixerConfig()``, a batch of
    MIXER_BATCH from seed 0, ``sgd(0.1)``): the losses of two steps from
    the same weights on the card and on the CPU, bf16 within rel 1e-2,
    f32 within rel 1e-4 (TF32 off); both fall."""
    import dataclasses

    from ompi_release_tpu_torch import entry as tentry
    from ompi_release_tpu_torch.models import mixer as mx
    from ompi_release_tpu_torch.optim import sgd
    from ompi_release_tpu_torch.parallel.mesh_axes import build_parallel_mesh

    out = {}
    for dtype, rtol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        cfg = dataclasses.replace(mx.MixerConfig(), dtype=dtype)
        base = mx.init_params(cfg, torch.Generator().manual_seed(0))
        patches, labels = tentry.mixer_batch(cfg)

        def run(device):
            params = copy_params(base, device)
            step = mx.make_train_step(cfg, build_parallel_mesh(
                devices=[device]))
            state = sgd(tentry.MIXER_LR)(params)
            return [float(step(params, state, patches, labels)[2])
                    for _ in range(2)]

        cpu, card = run(torch.device("cpu")), run(dev)
        name = str(dtype)[6:]
        out[name] = {"card": card, "cpu": cpu}
        for a, b in zip(card, cpu):
            check(abs(a - b) <= rtol * abs(b), f"Mixer {name}: card losses "
                                              f"{card} vs CPU {cpu}")
        check(card[1] < card[0], f"Mixer {name} loss did not fall: {card}")
    log(json.dumps({"mixer_card_vs_cpu": out}))
    log("phase 3: full-width Mixer step on the card == on the CPU (bf16 rel "
        "1e-2, f32 rel 1e-4); losses fall")


def check_main_path(tmvar, torch, runs, bench):
    n = N_RANKS
    for comm, method, x, kw, out in runs:
        what = f"{comm.name}.{method} {tuple(x.shape)} {x.dtype}"
        check(bool(torch.isfinite(out.float()).all()) if out.is_floating_point()
              else True, f"{what}: non-finite output")
        if method == "allreduce":
            check(out.shape == x.shape, f"{what}: shape {tuple(out.shape)}")
            if bool((x == 1).all()):
                check(bool((out == n).all()), f"{what}: all-ones != {n}")
            if comm.name == "MPI_COMM_WORLD":  # integer-valued: exact
                check(bits_equal(out, x.sum(0, keepdim=True).expand_as(x)
                                 .contiguous()), f"{what}: != exact sum")
        elif method == "reduce_scatter_block":
            want = x.view(n, n, -1).sum(0)  # integer-valued: exact
            check(bits_equal(out, want), f"{what}: != exact block sums")
        elif method == "bcast":
            check(bits_equal(out, x[kw["root"]].expand_as(x).contiguous()),
                  f"{what}: != root's buffer")
        elif method == "allgather":
            check(bits_equal(out, x.reshape(1, -1).expand(n, -1).contiguous()),
                  f"{what}: != concatenation")
        elif method == "alltoall":
            check(bits_equal(out, x.view(n, n, -1).transpose(0, 1)
                             .reshape(x.shape)), f"{what}: != transpose")
        if method in ("allreduce", "reduce_scatter_block"):
            # the same call with the CUDA op component excluded: the plain
            # add on the card, in the same algorithm order -> same bits
            tmvar.set_value("op", "^cuda")
            try:
                plain = getattr(comm, method)(x, **kw)
            finally:
                tmvar.VARS.unset("op")
            check(bits_equal(out, plain), f"{what}: != op ^cuda result")
    a, axpy_sum, scale_sum = bench
    acc = torch.zeros_like(a)
    for _ in range(4):
        acc = acc * 0.999 + a
    want = float(acc[0, 0] + acc[-1, -1])
    check(abs(axpy_sum - want) <= 1e-5 * abs(want), "axpy loop checksum")
    acc = a
    for _ in range(4):
        acc = acc * 1.0001
    want = float(acc[0, 0] + acc[-1, -1])
    check(abs(scale_sum - want) <= 1e-5 * abs(want), "scale loop checksum")
    torch.cuda.synchronize()
    log(f"phase 3: {len(runs)} collective results match the op ^cuda runs "
        "bitwise and their closed forms; bench loop checksums match")


def time_kernels(cuda_op, torch, dev, launches):
    """Each kernel at the main path's largest per-call shape (the
    segmented-ring combine at 256 MiB per rank: 2^26 f32 elements), the
    streaming kernels also in bf16 at the same bytes, and the SUM at the
    main path's smaller operand sizes (``SUM_SIZES``)."""
    numel = 1 << 26
    g = torch.Generator(device=dev).manual_seed(99)
    a = torch.randn(numel, generator=g, device=dev)
    b = torch.randn(numel, generator=g, device=dev)
    h = torch.randn(2, 2 * numel, generator=g, device=dev).to(torch.bfloat16)
    ha, hb = h[0], h[1]  # bf16 at the same bytes: 2^27 elements
    cases = {
        "sum": (lambda: cuda_op.sum_(a, b), lambda: cuda_op._plain_sum(a, b),
                lambda: torch.add(b, a), lambda: cuda_op.sum_(ha, hb),
                lambda: torch.add(hb, ha)),
        "axpy": (lambda: cuda_op.axpy(a, b, 0.999),
                 lambda: cuda_op._plain_axpy(a, b, 0.999),
                 lambda: torch.add(a, b, alpha=0.999),
                 lambda: cuda_op.axpy(ha, hb, 0.999),
                 lambda: torch.add(ha, hb, alpha=0.999)),
        "scale": (lambda: cuda_op.scale(a, 1.0001),
                  lambda: cuda_op._plain_scale(a, 1.0001),
                  lambda: torch.mul(a, 1.0001),
                  lambda: cuda_op.scale(ha, 1.0001),
                  lambda: torch.mul(ha, 1.0001)),
    }
    rows = []
    for name, (kern, plain, lib, kern_bf16, lib_bf16) in cases.items():
        replaces, streams = KERNELS[name]
        err = float((kern().float() - plain().float()).abs().max())
        ms = turns_ms({"ms": kern, "plain_ms": plain, "library_ms": lib},
                      inner=10)
        bf16 = turns_ms({"ms_bf16": kern_bf16, "library_ms_bf16": lib_bf16},
                        inner=10)
        extra = {}
        if name == "sum":
            extra["sizes"] = [time_sum_at(cuda_op, torch, a[:n], b[:n])
                              for n in SUM_SIZES]
        rows.append({
            "name": f"stream_{'scale' if name == 'scale' else 'axpy'}"
                    f"[{name}]",
            "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, **ms,
            "bound_ms": streams * numel * 4 / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "shape": [numel], "dtype": "float32",
            **bf16, **extra,
        })
    del a, b, h, ha, hb
    rows.append(time_transpose(cuda_op, torch, dev, launches["transpose"]))
    rows.append(time_chain(cuda_op, torch, dev, launches["chain"]))
    return rows


def interpreted_sum():
    """SUM's arithmetic under an op object the ring kernel does not
    claim: the ring bodies keep their interpreted passes for it."""
    from ompi_release_tpu_torch import ops

    return ops.user_op("sum_interpreted", lambda a, b: a + b,
                       identity=lambda d: 0)


def ring_body(alg, x, op, n, param):
    from ompi_release_tpu_torch.coll import pipeline, spmd

    if alg == "ring":
        return spmd.allreduce_ring(x, op, n)
    if alg == "pipelined":
        return pipeline.allreduce_ring_pipelined(x, op, n, param)
    return spmd.allreduce_segmented_ring(x, op, n, param)


def check_ring_fold(cuda_op, torch, dev):
    """``ring_fold`` bitwise its plain twin and the interpreted ring of
    each body on the card (``RING_FOLD_CASES`` at 2, 3, 5, 8, 9 and 16
    ranks, f32 and bf16, random signed values of spread magnitudes,
    aligned and at an element offset), each body taking the kernel once;
    under op ^cuda a body keeps its interpreted passes."""
    from ompi_release_tpu_torch import ops
    from ompi_release_tpu_torch.mca import var as tmvar

    interp = interpreted_sum()
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for n in (2, 3, 5, 8, 9, 16):
            for alg, total, param in RING_FOLD_CASES:
                g = torch.Generator(device=dev).manual_seed(total * 31 + n)
                base = torch.randn(n * total + 1, generator=g, device=dev)
                base = (base * torch.exp2(torch.randint(
                    -8, 9, base.shape, generator=g,
                    device=dev).float())).to(dtype)
                seg = max(param, n) if alg == "segmented" else total
                if -(-total // seg) <= 1:
                    seg = total
                for x in (base[:-1].view(n, total), base[1:].view(n, total)):
                    want = ring_body(alg, x, interp, n, param)
                    before = cuda_op.LAUNCHES["ring_fold"]
                    got = ring_body(alg, x, ops.SUM, n, param)
                    twin = cuda_op._plain_ring_fold(x, n, seg, -(-seg // n))
                    torch.cuda.synchronize()
                    check(cuda_op.LAUNCHES["ring_fold"] - before == 1,
                          f"ring_fold: the {alg} body did not take the "
                          "kernel")
                    check(bits_equal(got, want) and bits_equal(twin, want),
                          f"ring_fold: {alg} {n} x {total} {dtype} "
                          f"(offset {x.storage_offset()}) != the "
                          "interpreted ring")
                    n_cases += 1
    x = base[:-1].view(n, total)
    before = cuda_op.LAUNCHES["ring_fold"]
    plain = with_op_excluded(tmvar, lambda: ring_body(alg, x, ops.SUM, n,
                                                      param))
    torch.cuda.synchronize()
    check(cuda_op.LAUNCHES["ring_fold"] == before
          and bits_equal(plain, ring_body(alg, x, interp, n, param)),
          "ring_fold: op ^cuda took the kernel or changed the bits")
    log(f"phase 2: ring_fold bitwise its twin and the interpreted ring "
        f"in {n_cases} cases; none under op ^cuda")


def time_ring_fold(cuda_op, torch, dev, launches):
    """``ring_fold`` at the main path's shape (8 ranks x 256 MiB a rank,
    1 MiB segments), f32 and bf16, in turns with its plain twin and the
    interpreted segmented ring it replaces, all three bitwise equal."""
    interp = interpreted_sum()
    row = {"name": "ring_fold", "route": "cuda", "source": RING_FOLD_SOURCE,
           "replaces": RING_FOLD_REPLACES, "launches": launches,
           "bound_by": "bytes", "dtype": "float32"}
    for dtype, sfx in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        item = torch.tensor([], dtype=dtype).element_size()
        total = RING_FOLD_BYTES // item
        seg = RING_FOLD_SEG_BYTES // item
        chunk = -(-seg // N_RANKS)
        g = torch.Generator(device=dev).manual_seed(25)
        x = torch.randn(N_RANKS, total, generator=g, device=dev).to(dtype)
        fns = {f"ms{sfx}": lambda: cuda_op.ring_fold(x, N_RANKS, seg, chunk),
               f"plain_ms{sfx}": lambda: cuda_op._plain_ring_fold(
                   x, N_RANKS, seg, chunk),
               f"interpreted_ms{sfx}": lambda: ring_body(
                   "segmented", x, interp, N_RANKS, seg)}
        outs = [fn() for fn in fns.values()]
        check(bits_equal(outs[0], outs[1]) and bits_equal(outs[0], outs[2]),
              f"ring_fold {dtype} at 8 x 256 MiB != its twin or the "
              "interpreted ring")
        del outs
        ms = turns_ms(fns, reps=5)
        nbytes = 2 * N_RANKS * total * item
        row.update(ms)
        row[f"bound_ms{sfx}"] = nbytes / HBM_BYTES_PER_S * 1e3
        row[f"GBps{sfx}"] = nbytes / (ms[f"ms{sfx}"] * 1e-3) / 1e9
        row[f"shape{sfx}"] = [N_RANKS, total]
        row[f"seg{sfx}"] = seg
        del x, fns
        torch.cuda.empty_cache()
    return row


def ring_fold_host_us(cuda_op, torch, dev):
    """Host µs per ``ring_fold`` launch at (8, 512) f32 beside
    ``torch.add(x, 1)`` on the chain's tile, as :func:`host_launch_us`
    times every wrapper."""
    x = torch.randn(N_RANKS, 512, device=dev)
    tile = torch.randn(cuda_op.CHAIN_TILE, device=dev)
    cases = {"ring_fold": lambda: cuda_op.ring_fold(x, N_RANKS, 512, 64),
             "torch.add(x, 1)": lambda: torch.add(tile, 1)}
    rounds = {name: [] for name in cases}
    for r in range(3):
        for name in (list(cases) if r % 2 == 0 else list(cases)[::-1]):
            for _ in range(100):
                cases[name]()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                cases[name]()
            rounds[name].append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
            torch.cuda.synchronize()
    return {name: statistics.median(r) for name, r in rounds.items()}


def time_sum_at(cuda_op, torch, x, y):
    """The SUM kernel on f32 ``x`` and ``y`` in turns with
    ``torch.add(y, x)``: launched from Python (what the main path pays;
    below ~2^22 elements the host's launch cost, not the device, sets
    the pace) and replayed from a CUDA graph of ``GRAPH_CALLS`` calls
    (the device's time). At 2^20 elements the 12 MiB a call moves fit in
    the 50 MB L2, for both, so the device time may beat the HBM bound."""
    n = x.numel()
    kern = lambda: cuda_op.sum_(x, y)  # noqa: E731
    lib = lambda: torch.add(y, x)  # noqa: E731
    eager = turns_ms({"ms": kern, "library_ms": lib}, inner=GRAPH_CALLS)
    graph = turns_ms({"ms_graph": graphed(torch, kern, GRAPH_CALLS),
                      "library_ms_graph": graphed(torch, lib, GRAPH_CALLS)})
    return {"numel": n, **eager,
            **{k: t / GRAPH_CALLS for k, t in graph.items()},
            "bound_ms": 3 * n * 4 / HBM_BYTES_PER_S * 1e3}


def time_transpose(cuda_op, torch, dev, launches):
    """The transpose at alltoall_i32_torus's (8192, 8192) int32."""
    n = TRANSPOSE_N
    x = torch.randint(-2**31, 2**31 - 1, (n, n), device=dev,
                      dtype=torch.int32)
    err = float((cuda_op.transpose(x).double()
                 - cuda_op._plain_transpose(x).double()).abs().max())
    ms = turns_ms({"ms": lambda: cuda_op.transpose(x),
                   "plain_ms": lambda: cuda_op._plain_transpose(x),
                   "library_ms": lambda: x.t().contiguous()}, inner=10)
    return {
        "name": "tile_transpose_32", "route": "cuda", "source": SOURCE,
        "replaces": TRANSPOSE_REPLACES, "launches": launches,
        "max_abs_err": err, **ms,
        "bound_ms": 2 * n * n * 4 / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "shape": [n, n], "dtype": "int32",
    }


def time_flash(fa, torch, dev, launches, hgmma):
    """The flash forward at the main path's (B*H, S, D) = (64, 2048, 64)
    bf16 causal, beside its plain twin and SDPA on the same tensors
    viewed (8, 8, 2048, 64): SDPA by CUDA events (``library_ms``) and by
    its summed device time in a profiler window (``library_device_ms``),
    the kernel's own window beside it (``device_ms``), so that the factor
    compares device time with device time. Bound: 4*N*D*S(S+1)/2 flops
    at the bf16 tensor-core peak against q, k, v, o and lse moved once at
    the HBM rate (not recounted for the hi/lo split's third product); the
    f32 CUDA-core floor of the same flops is printed beside it."""
    n, s, d = FLASH_SHAPE
    g = torch.Generator(device=dev).manual_seed(99)
    q, k, v = (torch.randn(n, s, d, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    err = float((fa.flash_forward(q, k, v, True)[0].float()
                 - fa._plain_flash_forward(q, k, v, True)[0].float())
                .abs().max())
    flops = 4 * n * d * s * (s + 1) / 2
    nbytes = 4 * n * s * d * 2 + n * s * 4
    q4, k4, v4 = (t.view(8, n // 8, s, d) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    device_ms = {}
    for what, fn in (("sdpa", lambda: sdpa(q4, k4, v4, is_causal=True)),
                     ("kernel", lambda: fa.flash_forward(q, k, v, True))):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        prof = tbench.profile_window(fn, SDPA_FWD_CALLS)
        device_ms[what] = prof["device_busy_ms"] / SDPA_FWD_CALLS
        check(device_ms[what] > 0, f"no device time in the {what} forward "
                                   f"window {prof}")
        log(json.dumps({f"profile_{what}_forward": True, **prof}))
    return {
        "name": "flash_fwd", "route": "cuda", "source": FLASH_BF16_SOURCE,
        "f32_route_source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES, "launches": launches,
        "max_abs_err": err,
        "ms": time_ms(lambda: fa.flash_forward(q, k, v, True), inner=5),
        "plain_ms": time_ms(lambda: fa._plain_flash_forward(q, k, v, True),
                            reps=5),
        "bound_ms": max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3,
        "bound_by": "operations" if flops / BF16_FLOPS
        > nbytes / HBM_BYTES_PER_S else "bytes",
        "library_ms": time_ms(lambda: sdpa(q4, k4, v4, is_causal=True),
                              inner=5),
        "library": "SDPA is_causal",
        "device_ms": device_ms["kernel"],
        "library_device_ms": device_ms["sdpa"],
        "cuda_core_floor_ms": flops / F32_CUDA_CORE_FLOPS * 1e3,
        "sass_hgmma": hgmma["flash_fwd"],
        "shape": list(FLASH_SHAPE), "dtype": "bfloat16", "causal": True,
    }


def time_flash_bwd(fa, torch, dev, launches, hgmma):
    """The two backward kernels at the main path's (B*H, S, D) = (64,
    2048, 64) bf16 causal, each beside its own plain twin, and SDPA's
    backward on the same tensors viewed (8, 8, 2048, 64) (dq, dk and dv
    at once, so it stands in both rows; timed alone with its graph
    retained, its device time from a profiler window). Bound: dq does three (S, S, D) products and dk/dv four, at
    2*N*D*S(S+1)/2 flops each, over the bf16 tensor-core peak, against
    q, k, v, dO, lse, delta read and the outputs written once over the HBM
    rate; the f32 CUDA-core floor of the same flops beside it."""
    n, s, d = FLASH_SHAPE
    g = torch.Generator(device=dev).manual_seed(98)
    q, k, v, do = (torch.randn(n, s, d, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    out, lse = fa.flash_forward(q, k, v, True)
    args = (q, k, v, lse, do, fa._delta(out, do), True)
    q4, k4, v4 = (t.view(8, n // 8, s, d).detach().requires_grad_()
                  for t in (q, k, v))
    o4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4,
                                                           is_causal=True)
    g4 = do.view(8, n // 8, s, d)

    def sdpa_bwd():
        return torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True)

    # autograd's host time per call is about the device's, so CUDA events
    # around the call read host time too: take the kernels' summed device
    # time from a profiler window instead
    for _ in range(2):
        sdpa_bwd()
    torch.cuda.synchronize()
    prof = tbench.profile_window(sdpa_bwd, SDPA_BWD_CALLS)
    library_ms = prof["device_busy_ms"] / SDPA_BWD_CALLS
    check(library_ms > 0, f"no device time in SDPA's backward window {prof}")
    log(json.dumps({"profile_sdpa_backward": True, **prof}))
    product = 2 * n * d * s * (s + 1) / 2
    tensor_bytes = n * s * d * 2
    rows = []
    for name, kern, plain, replaces, products, outs in (
            ("flash_bwd_dq", fa._bwd_dq_kernel, fa._plain_bwd_dq,
             DQ_REPLACES, 3, 1),
            ("flash_bwd_dkv", fa._bwd_dkv_kernel, fa._plain_bwd_dkv,
             DKV_REPLACES, 4, 2)):
        got, want = kern(*args), plain(*args)
        if outs == 1:
            got, want = (got,), (want,)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
        flops = products * product
        nbytes = (4 + outs) * tensor_bytes + 2 * n * s * 4
        rows.append({
            "name": name, "route": "cuda", "source": FLASH_BWD_BF16_SOURCE,
            "f32_route_source": FLASH_BWD_SOURCE,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err,
            "ms": time_ms(lambda: kern(*args), inner=5),
            "plain_ms": time_ms(lambda: plain(*args), reps=5),
            "bound_ms": max(flops / BF16_FLOPS,
                            nbytes / HBM_BYTES_PER_S) * 1e3,
            "bound_by": "operations" if flops / BF16_FLOPS
            > nbytes / HBM_BYTES_PER_S else "bytes",
            "library_ms": library_ms,
            "library": "SDPA backward (dq, dk, dv at once)",
            "cuda_core_floor_ms": flops / F32_CUDA_CORE_FLOPS * 1e3,
            "sass_hgmma": hgmma[name],
            "shape": list(FLASH_SHAPE), "dtype": "bfloat16", "causal": True,
        })
    return rows


def eager_hops_ms(hops, x):
    """{name: ms per hop} over HOPS_TIMED dependent hops launched from
    Python, for each hop function of ``hops``, taken in turns."""
    def chain(hop):
        def run():
            y = x
            for _ in range(HOPS_TIMED):
                y = hop(y)
        return run

    ms = turns_ms({name: chain(hop) for name, hop in hops.items()})
    return {name: t / HOPS_TIMED for name, t in ms.items()}


def graphed(torch, fn, calls):
    """The replay of one CUDA graph holding ``calls`` calls of ``fn``
    (warmed up on a side stream first, as torch requires)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    return g.replay


def graph_hop_ms(torch, hop, x):
    """ms per hop over HOPS_TIMED dependent hops replayed from one CUDA
    graph holding all of them."""
    def chain():
        y = x
        for _ in range(HOPS_TIMED):
            y = hop(y)
        return y

    return time_ms(graphed(torch, chain, 1)) / HOPS_TIMED


def time_chain(cuda_op, torch, dev, launches):
    """The chain hop on its (8, 128) f32 tile, eager (in turns with its
    plain twin and torch.add(x, 1)) and in a graph, beside
    torch.add(x, 1) timed the same two ways."""
    x = torch.randn(cuda_op.CHAIN_TILE, device=dev)
    err = float((cuda_op.chain_hop(x) - cuda_op._plain_chain_hop(x))
                .abs().max())
    lib = lambda y: torch.add(y, 1)  # noqa: E731
    eager = eager_hops_ms({"kernel": cuda_op.chain_hop, "library": lib,
                           "plain": cuda_op._plain_chain_hop}, x)
    return {
        "name": "chain_add_one", "route": "cuda", "source": SOURCE,
        "replaces": CHAIN_REPLACES, "launches": launches,
        "max_abs_err": err,
        "ms": eager["kernel"],
        "ms_graph": graph_hop_ms(torch, cuda_op.chain_hop, x),
        "plain_ms": eager["plain"],
        "bound_ms": 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": eager["library"],
        "library_ms_graph": graph_hop_ms(torch, lib, x),
        "shape": list(cuda_op.CHAIN_TILE), "dtype": "float32",
        "per": "hop",
    }


def host_launch_us(cuda_op, fa, torch, dev):
    """Host µs per launch of every wrapper: ``time.perf_counter`` over
    HOST_CALLS back-to-back calls with no synchronize, at small shapes
    (the device finishes each launch before the host issues the next, so
    the host bounds the rate), beside ``torch.add(x, 1)`` on the chain's
    tile timed the same way. Median of 3 rounds, in turns (the order
    reversed every other round)."""
    g = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn(4096, generator=g, device=dev)
    tile = torch.randn(cuda_op.CHAIN_TILE, generator=g, device=dev)
    t = torch.randint(-2**31, 2**31 - 1, (64, 64), generator=g, device=dev,
                      dtype=torch.int32)
    q = torch.randn(1, 64, 64, generator=g, device=dev).to(torch.bfloat16)
    ring = torch.randn(N_RANKS, 512, generator=g, device=dev)
    out, lse = fa.flash_forward(q, q, q, True)
    args = (q, q, q, lse, q, fa._delta(out, q), True)
    cases = {  # the chain hop beside torch.add on the same tile
        "torch.add(x, 1)": lambda: torch.add(tile, 1),
        "chain": lambda: cuda_op.chain_hop(tile),
        "sum": lambda: cuda_op.sum_(x, x),
        "axpy": lambda: cuda_op.axpy(x, x, 0.999),
        "scale": lambda: cuda_op.scale(x, 1.0001),
        "transpose": lambda: cuda_op.transpose(t),
        "flash_fwd": lambda: fa.flash_forward(q, q, q, True),
        "flash_bwd_dq": lambda: fa._bwd_dq_kernel(*args),
        "flash_bwd_dkv": lambda: fa._bwd_dkv_kernel(*args),
        "ring_fold": lambda: cuda_op.ring_fold(ring, N_RANKS, 512, 64),
    }
    rounds = {name: [] for name in cases}
    for r in range(3):  # reversed every other round
        for name in (list(cases) if r % 2 == 0 else list(cases)[::-1]):
            fn = cases[name]
            for _ in range(100):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            rounds[name].append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
            torch.cuda.synchronize()
    us = {name: statistics.median(r) for name, r in rounds.items()}
    log(json.dumps({"host_us_per_launch": us, "rounds": rounds,
                    "calls": HOST_CALLS}))
    return us


def run_bench(torch, dev):
    """Phase 5: the port's bench suite in-process, headline last."""

    t0 = time.perf_counter()
    lines, headline = tbench.run_suite(dev)
    mfu = tbench.mfu_line(dev)
    check(mfu["metric"] == "transformer_fwdbwd_step"
          and (mfu.get("unstable") or mfu["mfu"] is not None),
          f"MFU line {mfu}")
    lines.append(mfu)
    for ln in lines + [headline]:
        check(ln["device"] == torch.cuda.get_device_name(dev),
              f"bench line without the card's name: {ln}")
        log(json.dumps(ln))
    check(headline["metric"] == "op_sum_256MiB_f32_hbm_bw",
          f"bench headline {headline['metric']}")
    log(f"phase 5: bench suite took {time.perf_counter() - t0:.1f} s")


def time_allreduce(tuned, torch, dev):
    """The tuned allreduce per size (slice 1's sizes and slice 10's
    sweep); returns {bytes per rank: ms}."""
    g = torch.Generator(device=dev).manual_seed(7)
    out = {}
    for nbytes in sorted({8, 4 << 10, 64 << 10, 4 * MIB, 16 * MIB,
                          256 * MIB} | set(S10_SIZES)):
        x = torch.randn(N_RANKS, max(1, nbytes // 4), generator=g,
                        device=dev)
        ms = time_ms(lambda: tuned.allreduce(x), reps=5)
        busbw = 2 * (N_RANKS - 1) / N_RANKS * nbytes / (ms * 1e-3) / 1e9
        log(json.dumps({"tuned_allreduce_bytes_per_rank": nbytes,
                        "ms": ms, "bus_GBps": busbw}))
        out[nbytes] = ms
        del x
    return out


def profile_allreduce(tuned, torch, dev):
    """Where the tuned allreduce's time goes: one profiler window of 3
    calls per size."""
    g = torch.Generator(device=dev).manual_seed(11)
    for nbytes in (4 * MIB, 256 * MIB):
        x = torch.randn(N_RANKS, nbytes // 4, generator=g, device=dev)
        tuned.allreduce(x)
        torch.cuda.synchronize()
        log(json.dumps({"profile_tuned_allreduce_bytes_per_rank": nbytes,
                        **tbench.profile_window(lambda: tuned.allreduce(x),
                                         3)}))
        del x


def time_model(torch, model):
    """The eval forward's ms per batch and tokens/s (host clock to a
    synchronize, 3 batches after the phase-3 run warmed it), one
    profiler window over one batch, and the peak device memory."""
    from ompi_release_tpu_torch import entry as tentry

    torch.cuda.reset_peak_memory_stats()
    evals = tentry.run_eval(model, seed=10)
    ms = statistics.median(m for _, m in evals)
    tokens = tentry.EVAL_BATCH * tentry.EVAL_SEQ
    log(json.dumps({"tpulm_eval_ms_per_batch": ms,
                    "ms_each": [m for _, m in evals],
                    "tokens_per_s": tokens / (ms * 1e-3),
                    "batch": [tentry.EVAL_BATCH, tentry.EVAL_SEQ],
                    "peak_device_memory_GiB":
                        torch.cuda.max_memory_allocated() / 2**30}))
    tok, tgt = tentry._batch(model.cfg, tentry.EVAL_BATCH, tentry.EVAL_SEQ)
    tok = torch.as_tensor(tok, device=model.device)
    tgt = torch.as_tensor(tgt, device=model.device)
    log(json.dumps({"profile_tpulm_eval_batch": True,
                    **tbench.profile_window(lambda: model(tok, tgt), 1)}))


def step_rate(torch, model, ms):
    """TFLOP/s and MFU of a (8, 2048) train step of ``ms`` ms: FLOPs from
    the closed form (``models.flops``), MFU against the card's bf16
    peak, beside the card's name and power limit."""
    from ompi_release_tpu_torch import entry as tentry
    from ompi_release_tpu_torch.models.flops import train_step_flops

    flops = train_step_flops(model.cfg, tentry.EVAL_BATCH, tentry.EVAL_SEQ)
    name, limit = tbench.card(model.device)
    peak = tbench.peak_flops(name)
    tflops = flops / (ms * 1e-3) / 1e12
    return {"flops_per_step": flops, "tflops_per_s": tflops,
            "mfu": tflops * 1e12 / peak if peak else None,
            "device": name, "power_limit": limit}


def time_moe(torch, model):
    """The MoE train step's ms per step, tokens/s, TFLOP/s (closed form)
    and peak memory (median of 3 steps after the slice-5 window warmed
    it), one profiler window over one step, and the one-hot einsums'
    products timed alone at the step's shapes (per layer: two of
    ``tec,td->ecd``, two of ``tec,ecd->td`` and one ``td,ecd->tec``,
    forward and backward) to give their share of the step."""
    from ompi_release_tpu_torch import entry as tentry
    from ompi_release_tpu_torch.parallel import ep

    torch.cuda.reset_peak_memory_stats()
    steps = tentry.run_train(model, 3, seed=10)
    ms = statistics.median(m for _, m in steps)
    tokens = tentry.EVAL_BATCH * tentry.EVAL_SEQ
    log(json.dumps({"tpulm_moe_train_ms_per_step": ms,
                    **step_rate(torch, model, ms),
                    "ms_each": [m for _, m in steps],
                    "losses": [loss for loss, _ in steps],
                    "tokens_per_s": tokens / (ms * 1e-3),
                    "n_experts": model.cfg.n_experts,
                    "capacity_factor": model.cfg.capacity_factor,
                    "peak_device_memory_GiB":
                        torch.cuda.max_memory_allocated() / 2**30}))
    tok, tgt = tentry._batch(model.cfg, tentry.EVAL_BATCH, tentry.EVAL_SEQ,
                             seed=10)
    tok = torch.as_tensor(tok, device=model.device)
    tgt = torch.as_tensor(tgt, device=model.device)
    prof = tbench.profile_window(lambda: model.train_step(tok, tgt), 1)
    log(json.dumps({"profile_tpulm_moe_train_step": True, **prof,
                    "host_gap_ms": prof["window_ms"]
                    - prof["device_busy_ms"]}))
    e, d = model.cfg.n_experts, model.cfg.d_model
    cap = max(1, int(model.cfg.capacity_factor * tokens / e))
    g = torch.Generator(device=model.device).manual_seed(3)
    logits = torch.randn(tokens, e, generator=g, device=model.device)
    with torch.no_grad():
        dispatch, combine = ep._one_hot_dispatch(logits, e, cap)
        x = torch.randn(tokens, d, generator=g, device=model.device)
        back = torch.randn(e, cap, d, generator=g, device=model.device)
        each = {
            "tec,td->ecd": time_ms(lambda: torch.einsum(
                "tec,td->ecd", dispatch, x), reps=5),
            "tec,ecd->td": time_ms(lambda: torch.einsum(
                "tec,ecd->td", combine, back), reps=5),
            "td,ecd->tec": time_ms(lambda: torch.einsum(
                "td,ecd->tec", x, back), reps=5)}
    per_step = model.cfg.n_layers * (2 * each["tec,td->ecd"]
                                     + 2 * each["tec,ecd->td"]
                                     + each["td,ecd->tec"])
    log(json.dumps({"moe_one_hot_einsums_ms": each,
                    "einsum_ms_per_step": per_step,
                    "share_of_step": per_step / ms,
                    "flops_each": 2 * tokens * e * cap * d}))


def time_mixer(torch):
    """The full-width Mixer's train step (``entry --mixer``: ``sgd(0.1)``
    on one fixed batch of MIXER_BATCH): one warm-up step, then 6, each
    timed on the host clock to a synchronize; the loss must fall. Prints
    the median ms, samples/s and peak memory, and one profiler window
    over one step."""
    from ompi_release_tpu_torch import entry as tentry
    from ompi_release_tpu_torch.models.mixer import MixerConfig, TpuMixer

    torch.cuda.reset_peak_memory_stats()
    model = TpuMixer(MixerConfig(), seed=0, lr=tentry.MIXER_LR)
    runs = tentry.run_mixer_train(model, 1 + tentry.TRAIN_STEPS)
    losses = [loss for loss, _ in runs]
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"Mixer train losses {losses}")
    ms = statistics.median(m for _, m in runs[1:])
    log(json.dumps({"mixer_train_ms_per_step": ms,
                    "ms_each": [m for _, m in runs[1:]], "losses": losses,
                    "samples_per_s": tentry.MIXER_BATCH / (ms * 1e-3),
                    "peak_device_memory_GiB":
                        torch.cuda.max_memory_allocated() / 2**30}))
    patches, labels = (torch.as_tensor(a, device=model.device)
                       for a in tentry.mixer_batch(model.cfg))
    prof = tbench.profile_window(lambda: model.train_step(patches, labels),
                          1)
    log(json.dumps({"profile_mixer_train_step": True, **prof}))


def time_train(torch, model):
    """The train step's ms per step and tokens/s (host clock to a
    synchronize; median of 3 steps after the slice-4 window warmed it),
    the peak device memory over those steps, and one profiler window
    over one step: busy share, top kernels and host gaps (window minus
    device busy time)."""
    from ompi_release_tpu_torch import entry as tentry

    torch.cuda.reset_peak_memory_stats()
    steps = tentry.run_train(model, 3, seed=10)
    ms = statistics.median(m for _, m in steps)
    tokens = tentry.EVAL_BATCH * tentry.EVAL_SEQ
    log(json.dumps({"tpulm_train_ms_per_step": ms,
                    **step_rate(torch, model, ms),
                    "ms_each": [m for _, m in steps],
                    "losses": [loss for loss, _ in steps],
                    "tokens_per_s": tokens / (ms * 1e-3),
                    "batch": [tentry.EVAL_BATCH, tentry.EVAL_SEQ],
                    "optimizer": [type(model.opt_state).__name__, {
                        k: model.opt_state.defaults[k]
                        for k in ("lr", "betas", "eps", "weight_decay")}],
                    "peak_device_memory_GiB":
                        torch.cuda.max_memory_allocated() / 2**30}))
    tok, tgt = tentry._batch(model.cfg, tentry.EVAL_BATCH, tentry.EVAL_SEQ,
                             seed=10)
    tok = torch.as_tensor(tok, device=model.device)
    tgt = torch.as_tensor(tgt, device=model.device)
    prof = tbench.profile_window(lambda: model.train_step(tok, tgt), 1)
    gap_ms = prof["window_ms"] - prof["device_busy_ms"]
    log(json.dumps({"profile_tpulm_train_step": True, **prof,
                    "host_gap_ms": gap_ms}))


# ---------------------------------------------------------------------------
# slice 6: the datatype engine, the rooted/scan/v collectives, the fusion
# buffer, the ml component and the tuning database
# ---------------------------------------------------------------------------

DARRAY_N = 8192  # the (8192, 8192) f32 global array: 256 MiB
DARRAY_GRID = (2, 4)  # BLOCK x CYCLIC(64) over a 2 x 4 process grid
DARRAY_CYCLIC = 64
MOE_RANKS = 4  # dropless_moe over world.create(ranks 0-3)
TIMING_REPS = 5  # median of 5 per slice-6 timing


def with_op_excluded(tmvar, fn):
    """``fn()`` with the CUDA op component excluded (``--mca op
    ^cuda``): the plain add on the card in the same algorithm order."""
    tmvar.set_value("op", "^cuda")
    try:
        return fn()
    finally:
        tmvar.VARS.unset("op")


def host_checksum(t):
    """The datatype checksum written independently on the host: bytes
    grouped by position mod 251, each group's sum times its weight, mod
    2^32."""
    import numpy as np

    b = t.detach().cpu().contiguous().numpy().reshape(-1).view(np.uint8)
    pad = (-b.size) % 251
    groups = np.concatenate([b, np.zeros(pad, np.uint8)]).reshape(-1, 251)
    sums = groups.sum(axis=0, dtype=np.int64)
    return int((sums * (np.arange(251, dtype=np.int64) + 1)).sum()
               & 0xFFFFFFFF)


def s6_datatypes(torch, dev):
    """The darray pieces of a 256 MiB global array, a subarray face, a
    vector column, external32 round trips and the on-card checksum."""
    import numpy as np
    from ompi_release_tpu_torch import datatype as dt

    G, (P0, P1) = DARRAY_N, DARRAY_GRID
    g = torch.Generator(device=dev).manual_seed(606)
    glob = torch.randn(G * G, generator=g, device=dev)
    t0 = time.perf_counter()
    types = [dt.create_darray(P0 * P1, r, [G, G],
                              [dt.DIST_BLOCK, dt.DIST_CYCLIC],
                              [dt.DARG_DEFAULT, DARRAY_CYCLIC], [P0, P1],
                              dt.FLOAT) for r in range(P0 * P1)]
    build_s = time.perf_counter() - t0
    rebuilt = torch.zeros_like(glob)
    for r, t in enumerate(types):
        conv = dt.Convertor(t)
        piece = conv.pack(glob)
        plain = glob[torch.from_numpy(t.offsets(1).astype(np.int64)).to(dev)]
        check(piece.numel() == G * G // (P0 * P1) and bits_equal(piece, plain),
              f"darray rank {r}: pack != plain indexing")
        rebuilt = conv.unpack(piece, rebuilt)
    check(bits_equal(rebuilt, glob), "darray: the 8 pieces unpacked into "
                                     "zeros != the global array")
    mat = glob.view(G, G)
    face = dt.Convertor(dt.create_subarray([G, G], [G, DARRAY_CYCLIC],
                                           [0, G // 2], dt.FLOAT))
    col = dt.Convertor(dt.create_vector(G, 1, G, dt.FLOAT))
    for what, conv, want in (
            ("subarray face", face,
             mat[:, G // 2:G // 2 + DARRAY_CYCLIC].reshape(-1)),
            ("vector column", col, mat[:, 0].contiguous())):
        p = conv.pack(glob)
        check(bits_equal(p, want), f"{what}: pack != plain slicing")
        back = conv.unpack(p, torch.zeros_like(glob))
        check(bits_equal(conv.pack(back), p) and
              bits_equal(conv.unpack(p, glob), glob),
              f"{what}: round trip not bitwise")
    # external32: one 4 MiB strided f32 payload and one bf16 payload
    blocks = MIB // 256  # 4 MiB of f32 in blocks of 256, stride 512
    src = glob[: blocks * 512]
    for wire, buf in ((dt.FLOAT, src),
                      (dt.BFLOAT16, src.to(torch.bfloat16))):
        t = dt.create_vector(blocks, 256, 512, wire)
        conv = dt.Convertor(t)
        raw = conv.pack_external(buf)
        payload = conv.pack(buf)
        bits = payload.view(torch.int16 if wire is dt.BFLOAT16
                            else torch.int32).cpu().numpy()
        check(np.array_equal(raw, np.frombuffer(
            bits.astype(bits.dtype.newbyteorder(">")).tobytes(), np.uint8)),
            f"external32 {wire.name}: bytes != big-endian payload")
        back = conv.unpack_external(raw, torch.zeros_like(buf))
        check(bits_equal(conv.pack(back), payload) and back.device == dev,
              f"external32 {wire.name}: round trip not bitwise")
    cs = dt.Convertor.checksum(glob)
    check(cs.device == dev and int(cs) == host_checksum(glob),
          "checksum of 256 MiB on the card != the host's")
    log(f"slice 6: datatypes: 8 darray pieces of {G * G // 8 * 4 / MIB:g} MiB "
        f"(maps built in {build_s:.2f} s on the host) pack to plain "
        "indexing and unpack to the global array bitwise; subarray face, "
        "vector column and external32 (f32 4 MiB, bf16) round-trip; "
        f"checksum {int(cs)} equals the host's")
    return glob, types


def s6_rooted_scan(mpi_world, tuned, tmvar, torch, dev):
    """gather/scatter linear and binomial at 64 MiB per rank, roots 0
    and 5; scan/exscan at 64 MiB (tuned's recursive doubling) and 4 KiB
    (the fused gather path)."""
    n, count = N_RANKS, 64 * MIB // 4
    g = torch.Generator(device=dev).manual_seed(61)
    x = torch.randn(n, count, generator=g, device=dev)
    runs = 0
    for alg in ("linear", "binomial"):
        tmvar.set_value("coll_tuned_gather_algorithm", alg)
        tmvar.set_value("coll_tuned_scatter_algorithm", alg)
        try:
            for root in (0, 5):
                out = tuned.gather(x, root=root)
                want = torch.zeros(n, n * count, device=dev)
                want[root] = x.reshape(-1)
                check(("tuned", "gather", alg, root) in tuned._coll_programs
                      and bits_equal(out, want),
                      f"gather {alg} root {root} != closed form")
                del out, want
                out = tuned.scatter(x, root=root)
                check(("tuned", "scatter", alg, root) in tuned._coll_programs
                      and bits_equal(out, x[root].view(n, -1)),
                      f"scatter {alg} root {root} != closed form")
                del out
                runs += 2
        finally:
            tmvar.VARS.unset("coll_tuned_gather_algorithm")
            tmvar.VARS.unset("coll_tuned_scatter_algorithm")
    from ompi_release_tpu_torch import ops as tops

    ints = torch.randint(-64, 64, (n, count), generator=g,
                         device=dev).float()
    for comm, size, path in ((mpi_world, count, "tuned"),
                             (mpi_world, 1024, "fused"),
                             (tuned, count, "tuned")):
        for name in ("scan", "exscan"):
            key = (("fused", "scan", tops.SUM, name == "exscan")
                   if path == "fused" else ("tuned", name, tops.SUM))
            xi = ints[:, :size].contiguous()
            got = getattr(comm, name)(xi)
            check(key in comm._coll_programs,
                  f"{comm.name} {name} at {size * 4} B did not take {path}")
            want = torch.cumsum(xi, 0)
            if name == "exscan":
                want = torch.cat([torch.zeros_like(want[:1]), want[:-1]])
            check(bits_equal(got, want), f"{comm.name} {name} at {size * 4} "
                                         "B: != torch.cumsum (exact)")
            xr = x[:, :size].contiguous()
            r = getattr(comm, name)(xr)
            check(bits_equal(r, with_op_excluded(
                tmvar, lambda: getattr(comm, name)(xr))),
                f"{comm.name} {name}: != op ^cuda")
            runs += 3
    log(f"slice 6: rooted/scan: {runs} calls (gather/scatter linear and "
        "binomial at 64 MiB, roots 0 and 5; scan/exscan 64 MiB on WORLD "
        "-> tuned, 4 KiB on WORLD -> fused, 64 MiB tuned) match closed "
        "forms and op ^cuda bitwise")


def ragged_counts(total_elems):
    """Counts 1:2:...:8 summing to at most ``total_elems``."""
    unit = total_elems // (N_RANKS * (N_RANKS + 1) // 2)
    return [unit * (i + 1) for i in range(N_RANKS)]


def s6_vcoll(tuned, torch, dev):
    n = N_RANKS
    counts = ragged_counts(256 * MIB // 4)
    g = torch.Generator(device=dev).manual_seed(62)
    bufs = [torch.randn(k, generator=g, device=dev) for k in counts]
    cat = torch.cat(bufs)
    check(bits_equal(tuned.allgatherv(bufs), cat), "allgatherv != concat")
    check(bits_equal(tuned.gatherv(bufs, root=3), cat), "gatherv != concat")
    parts = tuned.scatterv(cat, counts, root=6)
    check(all(bits_equal(p, b) for p, b in zip(parts, bufs)),
          "scatterv != root's slices")
    del parts
    total = sum(counts)
    xi = torch.randint(-64, 64, (n, total), generator=g, device=dev).float()
    red = xi.sum(0)
    outs = tuned.reduce_scatter(xi, counts)
    check(all(bits_equal(o, w) for o, w in zip(outs, red.split(counts))),
          "reduce_scatter (integer-valued) != exact block sums")
    log(f"slice 6: v-collectives: allgatherv/gatherv/scatterv/"
        f"reduce_scatter over counts 1:2:...:8 ({total * 4 / MIB:.1f} MiB "
        "f32) match their closed forms bitwise")
    del bufs, cat, xi, red, outs


def moe_assignments(torch, dev):
    """The (8, 2048) batch's 16,384 tokens embedded by the full-width
    MoE TpuLM at seed 0, and the argmax of its layer-0 router."""
    from ompi_release_tpu_torch import entry as tentry
    from ompi_release_tpu_torch.models.transformer import ModelConfig, TpuLM

    cfg = ModelConfig(n_experts=MOE_EXPERTS)
    model = TpuLM(cfg, seed=0, device=dev)
    params = model.params()
    tokens, _ = tentry._batch(cfg, tentry.EVAL_BATCH, cfg.max_seq)
    emb = params["embed"][torch.from_numpy(tokens).long().to(dev)]
    emb = emb.to(cfg.dtype).reshape(-1, cfg.d_model)
    logits = emb.float() @ params["layers"]["router"][0].float()
    assign = logits.argmax(dim=-1)
    del model, params, logits
    return emb, assign


def mpi_alltoallv_host(bufs, counts):
    """MPI_Alltoallv's receive buffers on the host, from numpy."""
    import numpy as np

    n = len(bufs)
    offs = np.concatenate([np.zeros((n, 1), np.int64),
                           np.cumsum(counts, axis=1)], axis=1)
    return [np.concatenate([bufs[j][offs[j, i]:offs[j, i] + counts[j, i]]
                            for j in range(n)]) for i in range(n)]


def s6_dropless(mpi_world, torch, dev):
    """dropless_moe over 4 ranks at the full-width MoE's shapes, and the
    alltoallv of its count matrix against a host MPI_Alltoallv."""
    import numpy as np
    from ompi_release_tpu_torch.mca import pvar as tpvar
    from ompi_release_tpu_torch.parallel.ep import dropless_moe

    emb, assign = moe_assignments(torch, dev)
    sub = mpi_world.create(mpi_world.group.incl(list(range(MOE_RANKS))),
                           name="moe4")
    per = emb.shape[0] // MOE_RANKS
    tokens = [emb[i * per:(i + 1) * per] for i in range(MOE_RANKS)]
    assigns = [assign[i * per:(i + 1) * per] for i in range(MOE_RANKS)]
    e_local = MOE_EXPERTS // MOE_RANKS

    def expert_fn(e, x):
        return x * (e + 1) + e

    outs = dropless_moe(sub, tokens, assigns, expert_fn, MOE_EXPERTS)
    for i in range(MOE_RANKS):
        want = torch.empty_like(tokens[i])
        for e in range(MOE_EXPERTS):
            sel = assigns[i] == e
            want[sel] = expert_fn(e, tokens[i][sel])
        check(outs[i].shape == tokens[i].shape and bits_equal(outs[i], want),
              f"dropless_moe rank {i}: output != expert_fn per token")
    # the count matrix, counted on the card, and the host's that routes
    counts_dev = torch.stack([torch.bincount(a // e_local,
                                             minlength=MOE_RANKS)
                              for a in assigns]).cpu().numpy()
    host_a = [a.cpu().numpy() for a in assigns]
    counts = np.stack([np.bincount(a // e_local, minlength=MOE_RANKS)
                       for a in host_a]).astype(np.int64)
    check(np.array_equal(counts_dev, counts), "count matrix (card) != host")
    per_expert = np.bincount(np.concatenate(host_a), minlength=MOE_EXPERTS)
    # the routing alltoallv itself, against MPI_Alltoallv on the host
    d = emb.shape[1]
    order = [np.argsort(a // e_local, kind="stable") for a in host_a]
    send = [t[torch.from_numpy(o).to(dev)].reshape(-1)
            for t, o in zip(tokens, order)]
    pad0 = tpvar.PVARS.lookup("vcoll_alltoallv_padded_elems").read()
    ovf0 = tpvar.PVARS.lookup("vcoll_alltoallv_overflow_elems").read()
    recv = sub.alltoallv(send, counts * d)
    padded = tpvar.PVARS.lookup("vcoll_alltoallv_padded_elems").read() - pad0
    overflow = (tpvar.PVARS.lookup("vcoll_alltoallv_overflow_elems").read()
                - ovf0)
    want = mpi_alltoallv_host([s.view(torch.int16).cpu().numpy()
                               for s in send], counts * d)
    check(all(np.array_equal(r.view(torch.int16).cpu().numpy(), w)
              for r, w in zip(recv, want)),
          "alltoallv at the dropless counts != host MPI_Alltoallv")
    payload = int(counts.sum()) * d
    log(json.dumps({"dropless_counts": counts.tolist(),
                    "tokens_per_expert": per_expert.tolist(),
                    "alltoallv_padded_elems": padded,
                    "alltoallv_overflow_elems": overflow,
                    "padded_over_payload": padded / payload}))
    log(f"slice 6: dropless_moe: {emb.shape[0]} bf16 tokens of width {d} "
        f"over {MOE_RANKS} ranks, none dropped, each output bitwise "
        "expert_fn(assign, token); count matrix matches; alltoallv matches "
        "MPI_Alltoallv on the host")
    return sub, send, counts * d, padded / payload


def grad_list(torch, dev, integer):
    """The full-width TpuLM's parameters unstacked per layer, as a data-
    parallel trainer hands its gradients over: 2 + 8 x 8 tensors, f32,
    one row per rank (integer-valued: every rank the same values)."""
    from ompi_release_tpu_torch.models.transformer import (
        ModelConfig, param_shapes)

    cfg = ModelConfig()
    shapes = param_shapes(cfg)
    flat = [("embed", shapes["embed"][0]), ("ln_f", shapes["ln_f"][0])]
    for layer in range(cfg.n_layers):
        for name, (shape, _) in shapes["layers"].items():
            flat.append((f"{name}{layer}", shape[1:]))
    g = torch.Generator(device=dev).manual_seed(63)
    out = []
    for _, shape in flat:
        if integer:
            x = torch.randint(-64, 64, shape, generator=g, device=dev).float()
            out.append(x.unsqueeze(0).expand((N_RANKS,) + tuple(shape)))
        else:
            out.append(torch.randn((N_RANKS,) + tuple(shape), generator=g,
                                   device=dev))
    return out


FUSION_CASES = {  # (threshold, capacity): the defaults; PyTorch DDP's
    "a": (64 << 10, 4 * MIB),      # bucket_cap_mb of 25 under a 64 MiB
    "b": (64 * MIB, 25 * MIB),     # threshold
}


def fused_grads(tuned, grads, case):
    """Every gradient through a fusion buffer of ``case`` (no max delay:
    the buckets follow the threshold and capacity alone)."""
    from ompi_release_tpu_torch.coll.fusion import FusionBuffer

    thr, cap = FUSION_CASES[case]
    fb = FusionBuffer(tuned, threshold=thr, capacity=cap,
                      max_delay_us=10 ** 9)
    hs = [fb.allreduce(x) for x in grads]
    fb.flush()
    return [h.result() for h in hs]


def s6_fusion(tuned, tmvar, cuda_op, torch, dev):
    from ompi_release_tpu_torch.coll import fusion  # noqa: F401  (pvars)
    from ompi_release_tpu_torch.mca import pvar as tpvar

    names = ("coll_fusion_flushes", "coll_fusion_batched",
             "coll_fusion_bytes_saved")
    ints = grad_list(torch, dev, integer=True)
    rand = grad_list(torch, dev, integer=False)
    info = {}
    for case in FUSION_CASES:
        before = [tpvar.PVARS.lookup(k).read() for k in names]
        s0 = sum_folds(cuda_op)
        outs = fused_grads(tuned, ints, case)
        sums = sum_folds(cuda_op) - s0
        after = [tpvar.PVARS.lookup(k).read() for k in names]
        for x, o in zip(ints, outs):
            check(bits_equal(o, (x * N_RANKS).contiguous()),
                  f"fusion ({case}): integer-valued result != 8 x")
        del outs
        got = fused_grads(tuned, rand, case)
        want = with_op_excluded(tmvar, lambda: fused_grads(tuned, rand, case))
        check(all(bits_equal(a, b) for a, b in zip(got, want)),
              f"fusion ({case}): != the same buckets under op ^cuda")
        del got, want
        info[case] = {k: a - b for k, a, b in zip(names, after, before)}
        info[case]["sum_launches"] = sums
        log(json.dumps({"fusion_case": case,
                        "threshold": FUSION_CASES[case][0],
                        "capacity": FUSION_CASES[case][1], **info[case]}))
    check(info["b"]["sum_launches"] > 0,
          "fusion (b): neither the SUM kernel nor the ring kernel launched")
    log(f"slice 6: fusion buffer: {len(ints)} gradient tensors "
        f"({sum(x[0].numel() for x in ints) * 4 / 1e6:.1f} MB a rank); "
        "(a) and (b) give 8 x exactly and the op ^cuda buckets' bits")
    return ints, rand


def s6_ml(mpi_world, tmvar, cuda_op, torch, dev):
    tmvar.set_value("coll_ml_local_size", 4)
    tmvar.set_value("coll", "ml,basic")
    try:
        ml = mpi_world.dup(name="ml")
    finally:
        tmvar.VARS.unset("coll")
        tmvar.VARS.unset("coll_ml_local_size")
    check(ml._coll_providers["allreduce"][0] == "ml",
          f"ml not first: {ml._coll_providers['allreduce']}")
    n = N_RANKS
    g = torch.Generator(device=dev).manual_seed(64)
    s0 = cuda_op.LAUNCHES["sum"]
    count = 256 * MIB // 4
    for integer in (True, False):
        x = (torch.randint(-64, 64, (n, count), generator=g,
                           device=dev).float() if integer else
             torch.randn(n, count, generator=g, device=dev))
        for name, kw in (("allreduce", {}), ("reduce", {"root": 5}),
                         ("reduce_scatter_block", {})):
            out = getattr(ml, name)(x, **kw)
            if integer:
                tot = x.sum(0)
                want = {"allreduce": tot.expand(n, -1),
                        "reduce": torch.zeros_like(x).index_copy_(
                            0, torch.tensor([5], device=dev), tot[None]),
                        "reduce_scatter_block": tot.view(n, -1)}[name]
                check(bits_equal(out, want.contiguous()),
                      f"ml {name}: != closed form")
            check(bits_equal(out, with_op_excluded(
                tmvar, lambda: getattr(ml, name)(x, **kw))),
                f"ml {name}: != op ^cuda")
            del out
        del x
    sums = cuda_op.LAUNCHES["sum"] - s0
    check(sums > 0, "ml: the SUM kernel did not launch")
    x = torch.randn(n, 64 * MIB // 4, generator=g, device=dev)
    check(bits_equal(ml.bcast(x, root=5), x[5].expand(n, -1).contiguous()),
          "ml bcast != root's buffer")
    check(bits_equal(ml.allgather(x),
                     x.reshape(1, -1).expand(n, -1).contiguous()),
          "ml allgather != concatenation")
    check(bits_equal(ml.alltoall(x), x.view(n, n, -1).transpose(0, 1)
                     .reshape(x.shape)), "ml alltoall != transpose")
    ml.barrier()
    log(f"slice 6: ml (2 x 4): allreduce/reduce/reduce_scatter_block at "
        "256 MiB match closed forms and op ^cuda bitwise "
        f"({sums} SUM launches); bcast/allgather/alltoall at 64 MiB match")
    return ml


def s6_tuning_db(mpi_world, tmvar, torch, dev):
    import tempfile

    from ompi_release_tpu_torch.tuning import db as tdb

    tmvar.set_value("coll", "tuned")
    try:
        comm = mpi_world.dup(name="tuned_db")
    finally:
        tmvar.VARS.unset("coll")
    from ompi_release_tpu_torch import ops as tops
    from ompi_release_tpu_torch.coll.components import _TunedModule

    x = torch.randn(N_RANKS, 16 * MIB // 4, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(65))
    fixed = _TunedModule(comm)._pick_allreduce(x, tops.SUM)
    check(fixed == "segmented_ring", f"fixed rules pick {fixed} at 16 MiB")
    with tempfile.TemporaryDirectory() as root:
        path = tdb.TuningDb(root).register(f"allreduce 0 {MIB} ring\n",
                                           tdb.active())
        tmvar.set_value("coll_tuned_use_dynamic_rules", True)
        tmvar.set_value("coll_tuning_db_dir", root)
        try:
            got = comm.allreduce(x)
        finally:
            tmvar.VARS.unset("coll_tuned_use_dynamic_rules")
            tmvar.VARS.unset("coll_tuning_db_dir")
    keys = [k[:3] for k in comm._coll_programs]
    check(keys == [("tuned", "allreduce", "ring")],
          f"db allreduce took {keys}, not ring")
    tmvar.set_value("coll_tuned_allreduce_algorithm", "ring")
    try:
        forced = comm.allreduce(x)
    finally:
        tmvar.VARS.unset("coll_tuned_allreduce_algorithm")
    check(bits_equal(got, forced), "db-selected ring != forced ring")
    comm.free()
    log(f"slice 6: tuning db: entry {path.rsplit('/', 1)[-1]} "
        f"({tdb.active().canon()}) made the 16 MiB tuned allreduce take "
        "ring (fixed rules: segmented_ring), bitwise equal to ring forced")


def phase_slice6(mpi_world, tuned, tmvar, cuda_op, torch, dev):
    """Slice 6's path with every launch counter at 0 before it; returns
    what its timings need and the SUM launches it made."""
    t0 = time.perf_counter()
    cuda_op.reset_launches()
    glob, types = s6_datatypes(torch, dev)
    s6_rooted_scan(mpi_world, tuned, tmvar, torch, dev)
    torch.cuda.empty_cache()
    s6_vcoll(tuned, torch, dev)
    torch.cuda.empty_cache()
    moe = s6_dropless(mpi_world, torch, dev)
    grads = s6_fusion(tuned, tmvar, cuda_op, torch, dev)
    torch.cuda.empty_cache()
    ml = s6_ml(mpi_world, tmvar, cuda_op, torch, dev)
    s6_tuning_db(mpi_world, tmvar, torch, dev)
    torch.cuda.synchronize()
    launches = dict(cuda_op.LAUNCHES)
    log(f"phase 3: slice-6 path launches {launches}")
    check(launches["sum"] > 0, "kernel wrapper sum launched no time on the "
                               "slice-6 path")
    log(f"slice 6: checks took {time.perf_counter() - t0:.1f} s")
    return {"glob": glob, "types": types, "moe": moe, "grads": grads,
            "ml": ml, "sum_launches": launches["sum"]}


def time_slice6(state, tuned, mpi_world, torch, dev):
    """The slice-6 timings, CUDA events, median of TIMING_REPS."""
    import numpy as np
    from ompi_release_tpu_torch import datatype as dt

    t0 = time.perf_counter()
    glob, types = state["glob"], state["types"]
    conv = dt.Convertor(types[0])
    piece = conv.pack(glob)
    idx64 = torch.from_numpy(types[0].offsets(1).astype(np.int64)).to(dev)
    idx32 = types[0].device_offsets(1, dev)
    elems = piece.numel()
    bound_ms = (2 * elems * 4 + elems * 4) / HBM_BYTES_PER_S * 1e3
    ms = turns_ms({"pack": lambda: conv.pack(glob),
                   "index_select_i32": lambda: glob.index_select(0, idx32),
                   "index_select_i64": lambda: glob.index_select(0, idx64),
                   "unpack": lambda: conv.unpack(piece, glob)},
                  reps=TIMING_REPS)
    gbps = {k: 3 * elems * 4 / (v * 1e-3) / 1e9 for k, v in ms.items()}
    log(json.dumps({"darray_piece_bytes": elems * 4, "ms": ms,
                    "GBps_vs_bound_bytes": gbps, "bound_ms": bound_ms,
                    "unpack_note": "unpack also copies the 256 MiB buffer "
                                   "(it never writes the caller's)"}))
    sub, send, counts, ratio = state["moe"]
    a2av = time_ms(lambda: sub.alltoallv(send, counts), reps=TIMING_REPS)
    log(json.dumps({"alltoallv_dropless_ms": a2av,
                    "padded_over_payload": ratio,
                    "payload_bytes": int(counts.sum()) * 2}))
    profiles = {"alltoallv_dropless": (lambda: sub.alltoallv(send, counts),
                                       3)}
    from ompi_release_tpu_torch.mca import pvar as tpvar

    _, rand = state["grads"]
    ways = {f"fused_{case}": (lambda c=case: fused_grads(tuned, rand, c))
            for case in FUSION_CASES}
    ways["per_tensor"] = lambda: [tuned.allreduce(x) for x in rand]
    issued = {}
    invocations = tpvar.PVARS.lookup("coll_invocations")
    for name, fn in ways.items():
        before = invocations.read()
        fn()
        issued[name] = invocations.read() - before
    fb_ms = {name: time_ms(fn, reps=TIMING_REPS, warmup=1)
             for name, fn in ways.items()}
    log(json.dumps({"gradient_allreduce_ms": fb_ms,
                    "collectives_issued": issued, "tensors": len(rand),
                    "bytes_per_rank": sum(x[0].numel() for x in rand) * 4}))
    profiles["gradients_fused_b"] = (ways["fused_b"], 1)
    profiles["gradients_per_tensor"] = (ways["per_tensor"], 1)
    ml = state["ml"]
    x = torch.randn(N_RANKS, 256 * MIB // 4, device=dev)
    ar = turns_ms({"ml": lambda: ml.allreduce(x),
                   "tuned": lambda: tuned.allreduce(x)}, reps=TIMING_REPS)
    busbw = {k: 2 * (N_RANKS - 1) / N_RANKS * 256 * MIB / (v * 1e-3) / 1e9
             for k, v in ar.items()}
    log(json.dumps({"allreduce_256MiB_ms": ar, "bus_GBps": busbw}))
    del x
    y = torch.randn(N_RANKS, 64 * MIB // 4, device=dev)
    scan_ms = time_ms(lambda: mpi_world.scan(y), reps=TIMING_REPS)
    log(json.dumps({"scan_64MiB_ms": scan_ms}))
    profiles["scan_64MiB"] = (lambda: mpi_world.scan(y), 1)
    x = torch.randn(N_RANKS, 256 * MIB // 4, device=dev)
    profiles["ml_allreduce_256MiB"] = (lambda: ml.allreduce(x), 1)
    # where each one's time goes: device busy share of a profiler window
    for name, (fn, calls) in profiles.items():
        fn()
        torch.cuda.synchronize()
        log(json.dumps({f"profile_{name}": tbench.profile_window(fn,
                                                                 calls)}))
    del x, y
    ml.free()
    sub.free()
    log(f"slice 6: timings took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# slice 7: nonblocking and persistent collectives, the frozen plans as CUDA
# graphs, topologies and intercommunicators
# ---------------------------------------------------------------------------

#: the tuned allreduce sweep's sizes per rank (the main path's)
SWEEP_BYTES = (8, 4 << 10, 64 << 10, 4 * MIB, 16 * MIB, 256 * MIB)
PERSISTENT_STARTS = 10  # allreduce_init starts on the 256 MiB buffer
HOST_FIRES = 200  # 8 B allreduces per host-time sample set, each from idle


def interpreted(comm, name, *args):
    """A collective's interpreted leg: its c_coll entry called directly,
    which is what ``coll_compiled=false`` runs (without the cvar write,
    which would void every frozen plan)."""
    return comm.c_coll[name](comm, *args)


def plan_entries(comm):
    from ompi_release_tpu_torch.coll import plan as tplan

    return {k: e for k, e in tplan._device_plans.items() if k[0] == comm.cid}


def bad_plans(comm, *families):
    """Why each of ``comm``'s plans (of ``families``, or all) that stays
    interpreted does."""
    return {str(k[1][:2]): e["bad"] for k, e in plan_entries(comm).items()
            if "bad" in e and (not families or k[1][0] in families)}


def check_frozen(comm, calls, what):
    """Every signature ``comm`` fired has a frozen plan with a graph."""
    entries = plan_entries(comm)
    check(len(entries) >= calls, f"{what}: {len(entries)} plans for "
                                 f"{calls} signatures")
    for key, e in entries.items():
        check("bad" not in e and e["frozen"].graph is not None,
              f"{what}: plan {key[1][:2]} is not a captured graph: "
              f"{e.get('bad')}")


def hits():
    from ompi_release_tpu_torch.mca import pvar as tpvar

    st = tpvar.PVARS.lookup("coll_compiled_cache_hits").read()
    return int(st["count"]), int(st["sum"])


def comm_with(world, tmvar, coll, **cvars):
    for k, v in dict(coll=coll, **cvars).items():
        tmvar.set_value(k, v)
    try:
        return world.dup(name=f"s7_{coll.split(',')[0]}")
    finally:
        for k in dict(coll=coll, **cvars):
            tmvar.VARS.unset(k)


def s7_ifamily(tuned, tmvar, torch, dev):
    """Each i-collective and ibarrier against its blocking call with
    ``coll_compiled=false``, bitwise, three fires each (the interpreted
    capture, the graph capture, a replay); the SUM also against op ^cuda."""
    from ompi_release_tpu_torch import ops as tops

    n = N_RANKS
    g = torch.Generator(device=dev).manual_seed(70)
    x = torch.randn(n, 4 * MIB // 4, generator=g, device=dev)
    rs_counts = [(i % 3 + 1) * 65536 for i in range(n)]
    xrs = torch.randn(n, sum(rs_counts), generator=g, device=dev)
    v_counts = [[((i + 2 * j) % 4 + 1) * 16384 for j in range(n)]
                for i in range(n)]
    v_bufs = [torch.randn(sum(v_counts[i]), generator=g, device=dev)
              for i in range(n)]
    ragged = [torch.randn((i + 1) * 65536, generator=g, device=dev)
              for i in range(n)]
    cases = [
        ("iallreduce", "allreduce", (x, tops.SUM)),
        ("ireduce", "reduce", (x, tops.SUM, 5)),
        ("ibcast", "bcast", (x, 3)),
        ("iallgather", "allgather", (x,)),
        ("igather", "gather", (x, 5)),
        ("iscatter", "scatter", (x, 2)),
        ("ireduce_scatter_block", "reduce_scatter_block", (x, tops.SUM)),
        ("ireduce_scatter", "reduce_scatter", (xrs, rs_counts, tops.SUM)),
        ("ialltoall", "alltoall", (x,)),
        ("iscan", "scan", (x, tops.SUM)),
        ("iexscan", "exscan", (x, tops.SUM)),
        ("ialltoallv", "alltoallv", (v_bufs, v_counts)),
        ("iallgatherv", "allgatherv", (ragged,)),
    ]
    tmvar.set_value("coll_compiled", False)
    try:
        wants = [getattr(tuned, b)(*args) for _, b, args in cases]
    finally:
        tmvar.VARS.unset("coll_compiled")
    plain = with_op_excluded(tmvar, lambda: tuned.allreduce(x))
    check(bits_equal(wants[0], plain), "allreduce != op ^cuda")

    def same(got, want):
        if isinstance(want, (list, tuple)):
            return len(got) == len(want) and all(
                same(a, b) for a, b in zip(got, want))
        return bits_equal(got, want)

    for (iname, _, args), want in zip(cases, wants):
        for fire in range(3):
            req = getattr(tuned, iname)(*args)
            req.wait()
            check(req.test()[0] and same(req.value, want),
                  f"{iname} fire {fire} != blocking (coll_compiled=false)")
    rb = tuned.ibarrier()
    rb.wait()
    check(rb.test()[0], "ibarrier did not complete")
    # the general reduce_scatter slices the body's output: interpreted
    bad = bad_plans(tuned, *{b for _, b, _ in cases} - {"reduce_scatter"})
    check(not bad, f"i-family plans not captured: {bad}")
    log(f"slice 7: {len(cases)} i-collectives x 3 fires and ibarrier equal "
        "their blocking calls bitwise; iallreduce equals op ^cuda")


def s7_async(tuned, torch, dev):
    """A 256 MiB-a-rank iallreduce in steady state returns before it
    completes."""
    from ompi_release_tpu_torch import ops as tops

    x = torch.randn(N_RANKS, 256 * MIB // 4, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(71))
    for _ in range(2):  # the interpreted capture, the graph capture
        tuned.iallreduce(x).wait()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    req = tuned.iallreduce(x)
    dispatch_ms = (time.perf_counter() - t0) * 1e3
    done_at_dispatch = req.test()[0]
    req.wait()
    total_ms = (time.perf_counter() - t0) * 1e3
    log(json.dumps({"iallreduce_256MiB_dispatch_ms": dispatch_ms,
                    "completion_ms": total_ms,
                    "test_right_after_dispatch": done_at_dispatch}))
    check(not done_at_dispatch and dispatch_ms < total_ms,
          "iallreduce at 256 MiB did not return before completion")
    check(not bad_plans(tuned, "allreduce"),
          f"plans not captured: {bad_plans(tuned)}")
    check(bits_equal(req.value, interpreted(tuned, "allreduce", x,
                                            tops.SUM)),
          "iallreduce at 256 MiB != the interpreted call")


def s7_persistent(tuned, torch, dev):
    """allreduce_init on a 256 MiB-a-rank buffer started ten times, its
    contents redrawn in place between starts: every result is the
    interpreted call's, bitwise; one capturing fire, then hits."""
    from ompi_release_tpu_torch import ops as tops

    g = torch.Generator(device=dev).manual_seed(72)
    buf = torch.empty(N_RANKS, 256 * MIB // 4, device=dev)
    req = tuned.allreduce_init(buf)
    c0, s0 = hits()
    for k in range(PERSISTENT_STARTS):
        buf.normal_(generator=g)
        want = interpreted(tuned, "allreduce", buf, tops.SUM)
        req.start()
        req.wait()
        check(bits_equal(req.value, want),
              f"allreduce_init start {k} != the interpreted call")
        del want
    c1, s1 = hits()
    check((c1 - c0, s1 - s0) == (PERSISTENT_STARTS, PERSISTENT_STARTS - 1),
          f"persistent starts: {c1 - c0} fires, {s1 - s0} hits; "
          f"{bad_plans(tuned)}")
    log(f"slice 7: allreduce_init at 256 MiB: {PERSISTENT_STARTS} starts "
        f"bitwise the interpreted call; {c1 - c0} fires, {s1 - s0} hits")


def s7_plans(world, tuned, tmvar, torch, dev):
    """The main path's families freeze as CUDA graphs on every provider,
    each replay bitwise the interpreted leg."""
    from ompi_release_tpu_torch import ops as tops
    from ompi_release_tpu_torch.mca import pvar as tpvar

    failures = tpvar.PVARS.lookup("coll_graph_capture_failures").read()
    g = torch.Generator(device=dev).manual_seed(73)
    fams = ("bcast", "allgather", "reduce_scatter_block", "alltoall")

    def fire3(comm, name, *args):
        want = interpreted(comm, name, *args)
        for fire in range(3):
            check(bits_equal(getattr(comm, name)(*args), want),
                  f"{comm.name}.{name} fire {fire} != interpreted")

    comms = {"tuned": tuned,
             "fused": comm_with(world, tmvar, "fused"),
             "ml": comm_with(world, tmvar, "ml,basic",
                             coll_ml_local_size=4),
             "basic": comm_with(world, tmvar, "basic")}
    fired = {}
    for cname, comm in comms.items():
        sizes = SWEEP_BYTES if cname == "tuned" else (4 * MIB, 64 * MIB)
        for nbytes in sizes:
            x = torch.randn(N_RANKS, nbytes // 4, generator=g, device=dev)
            fire3(comm, "allreduce", x, tops.SUM)
        calls = len(sizes)
        if cname != "basic":
            x = torch.randn(N_RANKS, 4 * MIB // 4, generator=g, device=dev)
            for name in fams:
                args = (x, 3) if name == "bcast" else \
                    (x, tops.SUM) if name == "reduce_scatter_block" else (x,)
                fire3(comm, name, *args)
            calls += len(fams)
        check_frozen(comm, calls, cname)
        fired[cname] = calls
        del x
    check(tpvar.PVARS.lookup("coll_graph_capture_failures").read()
          == failures, "a main-path capture failed")
    for name in ("fused", "ml", "basic"):
        comms[name].free()
    torch.cuda.empty_cache()
    log(f"slice 7: every main-path family captured as a CUDA graph "
        f"(signatures per provider {fired}); every replay bitwise the "
        "interpreted leg")


def s7_replay_profile(world, tmvar, torch, dev):
    """A profiler window over a fresh signature's four fires (the
    interpreted capture, the graph capture and replay, two replays): the
    SUM runs in every one of them, replays included: at 16 MiB the tuned
    segmented ring's one ``ring_fold`` kernel. Then a window of replays
    alone (logged)."""
    from torch.profiler import ProfilerActivity, profile

    comm = comm_with(world, tmvar, "tuned")
    x = torch.randn(N_RANKS, 16 * MIB // 4, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(74))

    def fold_count(prof):
        return sum(e.count for e in prof.key_averages()
                   if "ring_fold_kernel" in e.key
                   and str(getattr(e, "device_type", "")).endswith("CUDA"))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        outs = [comm.allreduce(x) for _ in range(4)]
        torch.cuda.synchronize()
    (entry,) = plan_entries(comm).values()
    per_fire = entry["frozen"].launches.get("ring_fold", 0)
    seen = fold_count(prof)
    log(json.dumps({"profile_capture_and_replays": {
        "ring_fold_kernel_launches": seen, "per_fire": per_fire,
        "fires": 4}}))
    check(per_fire > 0 and seen == 4 * per_fire,
          f"profiler window shows {seen} ring_fold_kernel launches for 4 "
          f"fires of {per_fire}")
    check(all(bits_equal(o, outs[0]) for o in outs), "replays differ")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            comm.allreduce(x)
        torch.cuda.synchronize()
    log(json.dumps({"profile_replays_only": {
        "ring_fold_kernel_launches": fold_count(prof), "per_fire": per_fire,
        "fires": 2}}))
    comm.free()


def s7_index_cache(tuned, torch, dev):
    """Clear the index cache and overwrite the memory it freed: a replay
    still gives the same bits (the plan holds every index its graph
    reads)."""
    import gc

    from ompi_release_tpu_torch.coll import spmd

    x = torch.randn(N_RANKS, 16 * MIB // 4, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(75))
    for _ in range(2):
        tuned.allreduce(x)
    want = tuned.allreduce(x)
    torch.cuda.synchronize()
    spmd._build.cache_clear()
    gc.collect()
    junk = [torch.full((64,), 2 ** 40, dtype=torch.int64, device=dev)
            for _ in range(20000)]
    got = tuned.allreduce(x)
    torch.cuda.synchronize()
    check(bits_equal(got, want), "replay changed after the index cache was "
                                 "cleared and its memory overwritten")
    del junk
    log("slice 7: a replay after clearing the index cache and overwriting "
        "its freed memory gives the same bits")


def s7_recapture(tuned, tmvar, torch, dev):
    """A tuned cvar write: the next fire re-captures and follows it."""
    from ompi_release_tpu_torch import ops as tops

    x = torch.randn(N_RANKS, 4 * MIB // 4, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(76))
    for _ in range(2):
        tuned.allreduce(x)
    tmvar.set_value("coll_tuned_allreduce_algorithm", "recursive_doubling")
    try:
        c0, s0 = hits()
        got = [tuned.allreduce(x) for _ in range(3)]
        c1, s1 = hits()
        want = interpreted(tuned, "allreduce", x, tops.SUM)
    finally:
        tmvar.VARS.unset("coll_tuned_allreduce_algorithm")
    check((c1 - c0, s1 - s0) == (3, 2), f"after a cvar write: {c1 - c0} "
                                        f"fires, {s1 - s0} hits")
    check(any(k[:3] == ("tuned", "allreduce", "recursive_doubling")
              for k in tuned._coll_programs),
          "the re-capture did not follow the forced algorithm")
    check(all(bits_equal(o, want) for o in got),
          "the re-captured plan != the forced interpreted call")
    log("slice 7: a tuned cvar write re-captured at the next fire and "
        "followed the forced algorithm, bitwise")


def s7_free(world, tmvar, torch, dev):
    """Freeing a comm returns its graphs' memory."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_alloc = torch.cuda.memory_allocated(dev)
    base_res = torch.cuda.memory_reserved(dev)
    comm = comm_with(world, tmvar, "tuned")
    x = torch.randn(N_RANKS, 64 * MIB // 4, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(77))
    for _ in range(3):
        comm.allreduce(x)
        comm.bcast(x, 2)
    del x
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev) - base_alloc
    comm.free()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    after_alloc = torch.cuda.memory_allocated(dev) - base_alloc
    after_res = torch.cuda.memory_reserved(dev) - base_res
    log(json.dumps({"graph_memory_held_MiB": held / MIB,
                    "after_free_allocated_MiB": after_alloc / MIB,
                    "after_free_reserved_MiB": after_res / MIB}))
    check(held > 512 * MIB, f"two 64 MiB plans hold only {held / MIB} MiB")
    check(after_alloc <= MIB and after_res <= 64 * MIB,
          f"freeing the comm left {after_alloc / MIB} MiB allocated, "
          f"{after_res / MIB} MiB reserved")


def s7_uncapturable(tuned, torch, dev):
    """A body that syncs with the host cannot be captured: its plan turns
    "bad", stays interpreted and counts, and its result stays right."""
    from ompi_release_tpu_torch import ops as tops
    from ompi_release_tpu_torch.mca import pvar as tpvar

    failures = tpvar.PVARS.lookup("coll_graph_capture_failures")
    f0 = failures.read()
    op = tops.user_op("sum_host_sync",
                      lambda a, b: (float(b.reshape(-1)[0]), a + b)[1])
    x = torch.randn(N_RANKS, 4096, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(78))
    want = interpreted(tuned, "allreduce", x, op)
    outs = [tuned.allreduce(x, op) for _ in range(3)]
    check(all(bits_equal(o, want) for o in outs),
          "an uncapturable body gave another result")
    bad = [k for k, e in plan_entries(tuned).items()
           if "bad" in e and ("op", op) in k[1]]
    check(failures.read() == f0 + 1 and len(bad) == 1,
          f"capture failures {failures.read() - f0}, bad plans {len(bad)}")
    log("slice 7: a host-syncing body failed its capture once, stayed "
        "interpreted and gave the interpreted bits")


def s7_torus(world, torch, dev):
    """BASELINE config 5 on a 2D torus: the (4, 2) periodic cart comm's
    alltoall of int32 at 8 MiB a rank against the closed-form
    permutation, and the neighborhood collectives at 16 MiB a rank
    against index-built expectations, blocking and nonblocking."""
    from ompi_release_tpu_torch.topo import cart_create, dims_create

    n = N_RANKS
    dims = dims_create(n, 2)
    cart, topo = cart_create(world, dims, periods=[True, True])
    check(dims == (4, 2) and topo.dims == (4, 2), f"dims {dims}")
    g = torch.Generator(device=dev).manual_seed(79)
    x = torch.randint(-2**31, 2**31 - 1, (n, 8 * MIB // 4), generator=g,
                      device=dev, dtype=torch.int32)
    for _ in range(3):
        out = cart.alltoall(x)
        check(bits_equal(out, x.view(n, n, -1).transpose(0, 1)
                         .reshape(x.shape)),
              "config 5 alltoall on the (4, 2) torus != the permutation")
    nbrs = [topo.neighbors(r) for r in range(n)]
    y = torch.randn(n, 16 * MIB // 4, generator=g, device=dev)
    want = torch.stack([torch.stack([y[s] for s in row]) for row in nbrs])
    blocks = torch.randn(n, 4, 16 * MIB // 16, generator=g, device=dev)
    want_a2a = torch.stack([torch.stack([blocks[s, j ^ 1]
                                         for j, s in enumerate(row)])
                            for row in nbrs])
    check(bits_equal(topo.neighbor_allgather(y), want),
          "neighbor_allgather != the index-built expectation")
    check(bits_equal(topo.neighbor_alltoall(blocks), want_a2a),
          "neighbor_alltoall != the index-built expectation")
    r1, r2 = topo.ineighbor_allgather(y), topo.ineighbor_alltoall(blocks)
    r1.wait()
    r2.wait()
    check(bits_equal(r1.value, want) and bits_equal(r2.value, want_a2a),
          "ineighbor_* != the index-built expectations")
    cart.free()
    log("slice 7: config 5's alltoall on the (4, 2) periodic cart comm "
        "equals the closed-form permutation; neighbor_allgather/alltoall "
        "and their ineighbor twins equal index-built expectations")


def s7_intercomm(world, tmvar, torch, dev):
    """A 4 + 4 intercomm over WORLD's halves: the inter-allreduce at 64
    MiB a rank SUM against op ^cuda bitwise, and the merge ordering."""
    from ompi_release_tpu_torch.comm import intercomm_create

    lo = world.create(world.group.incl([0, 1, 2, 3]), name="s7_lo")
    hi = world.create(world.group.incl([4, 5, 6, 7]), name="s7_hi")
    ia, ib = intercomm_create(lo, 0, hi, 0)
    g = torch.Generator(device=dev).manual_seed(80)
    a = torch.randn(4, 64 * MIB // 4, generator=g, device=dev)
    b = torch.randn(4, 64 * MIB // 4, generator=g, device=dev)
    outs = [ia.allreduce(a, b) for _ in range(3)]
    back = ib.allreduce(b, a)
    plain = with_op_excluded(tmvar, lambda: ia.allreduce(a, b))
    check(all(bits_equal(o, plain) for o in outs),
          "inter-allreduce at 64 MiB != op ^cuda")
    check(bits_equal(back, with_op_excluded(tmvar,
                                            lambda: ib.allreduce(b, a))),
          "the mirror's inter-allreduce != op ^cuda")
    req = ia.iallreduce(a, b)
    req.wait()
    check(bits_equal(req.value, plain), "inter-iallreduce != op ^cuda")
    check(ia.merge(high=False).group.world_ranks == tuple(range(8))
          and ia.merge(high=True).group.world_ranks
          == (4, 5, 6, 7, 0, 1, 2, 3), "intercomm merge ordering")
    log("slice 7: the 4 + 4 inter-allreduce at 64 MiB equals op ^cuda "
        "bitwise; merge orders low group first")


def phase_slice7(world, tuned, tmvar, cuda_op, torch, dev):
    """Slice 7's path with every launch counter at 0 before it; returns
    the SUM launches it made (replays counted once each)."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_op.reset_launches()
    s7_ifamily(tuned, tmvar, torch, dev)
    s7_async(tuned, torch, dev)
    s7_persistent(tuned, torch, dev)
    torch.cuda.empty_cache()
    s7_plans(world, tuned, tmvar, torch, dev)
    s7_replay_profile(world, tmvar, torch, dev)
    s7_index_cache(tuned, torch, dev)
    s7_recapture(tuned, tmvar, torch, dev)
    s7_torus(world, torch, dev)
    s7_intercomm(world, tmvar, torch, dev)
    torch.cuda.synchronize()
    launches = dict(cuda_op.LAUNCHES)
    log(f"phase 3: slice-7 path launches {launches}")
    check(launches["sum"] > 0, "kernel wrapper sum launched no time on the "
                               "slice-7 path")
    s7_free(world, tmvar, torch, dev)
    s7_uncapturable(tuned, torch, dev)
    log(json.dumps({"slice7_peak_memory_GiB":
                    torch.cuda.max_memory_allocated(dev) / 2 ** 30}))
    log(f"slice 7: checks took {time.perf_counter() - t0:.1f} s")
    return launches["sum"]


def time_slice7(tuned, torch, dev):
    """Slice 7's timings, the frozen plan (a CUDA-graph replay) and the
    interpreted leg in turns (not gates): the tuned allreduce per sweep
    size, a persistent start at 256 MiB (no input copy) beside the
    iallreduce and the interpreted call, host µs per fire, the 66-tensor gradient list one allreduce per
    tensor, each case's busy share in a profiler window, the input copy
    and output clone a replay adds at 256 MiB, and the peak memory."""
    from ompi_release_tpu_torch import ops as tops

    sum_op = tops.SUM
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    g = torch.Generator(device=dev).manual_seed(81)
    sweep = {}
    for nbytes in SWEEP_BYTES:
        x = torch.randn(N_RANKS, nbytes // 4, generator=g, device=dev)
        ms = turns_ms({"plan": lambda: tuned.allreduce(x),
                       "interpreted": lambda: interpreted(
                           tuned, "allreduce", x, sum_op)},
                      reps=TIMING_REPS)
        sweep[nbytes] = ms
        if nbytes in (4 * MIB, 256 * MIB):
            for leg, fn in (("plan", lambda: tuned.allreduce(x)),
                            ("interpreted", lambda: interpreted(
                                tuned, "allreduce", x, sum_op))):
                log(json.dumps({f"profile_{leg}_allreduce_{nbytes}":
                                tbench.profile_window(fn, 3)}))
        del x
    log(json.dumps({"tuned_allreduce_ms_plan_vs_interpreted": sweep}))
    buf = torch.randn(N_RANKS, 256 * MIB // 4, generator=g, device=dev)
    req = tuned.allreduce_init(buf)

    def start():
        req.start()
        req.wait()

    log(json.dumps({"allreduce_256MiB_ms_persistent_vs_iallreduce": turns_ms(
        {"persistent_start": start,
         "iallreduce": lambda: tuned.iallreduce(buf).wait(),
         "interpreted": lambda: interpreted(tuned, "allreduce", buf,
                                            sum_op)}, reps=TIMING_REPS)}))
    del req, buf
    x = torch.randn(N_RANKS, 2, generator=g, device=dev)
    host = {"plan": [], "interpreted": []}
    fns = {"plan": lambda: tuned.allreduce(x),
           "interpreted": lambda: interpreted(tuned, "allreduce", x,
                                              sum_op)}
    for r in range(4):  # each call timed from an idle card: its host time
        for leg in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            for _ in range(HOST_FIRES):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                fns[leg]()
                host[leg].append((time.perf_counter() - t1) * 1e6)
    torch.cuda.synchronize()
    log(json.dumps({"host_us_per_8B_allreduce": {
        k: statistics.median(v) for k, v in host.items()}}))
    grads = grad_list(torch, dev, integer=False)
    legs = {"plan": lambda: [tuned.allreduce(t) for t in grads],
            "interpreted": lambda: [interpreted(tuned, "allreduce", t,
                                                sum_op) for t in grads]}
    log(json.dumps({"gradient_list_per_tensor_ms":
                    turns_ms(legs, reps=TIMING_REPS)}))
    for leg, fn in legs.items():
        log(json.dumps({f"profile_{leg}_gradient_list":
                        tbench.profile_window(fn, 1)}))
    del grads
    x = torch.randn(N_RANKS, 256 * MIB // 4, generator=g, device=dev)
    si, so = x.clone(), x.clone()
    log(json.dumps({"replay_extra_ms_256MiB": {
        "input_copy": time_ms(lambda: si.copy_(x), reps=TIMING_REPS),
        "output_clone": time_ms(lambda: so.clone(), reps=TIMING_REPS),
        "bound_each": 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3}}))
    del x, si, so
    log(json.dumps({"slice7_timings_peak_memory_GiB":
                    torch.cuda.max_memory_allocated(dev) / 2 ** 30}))
    log(f"slice 7: timings took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# slice 8: one-sided windows with frozen epoch plans as CUDA graphs,
# OpenSHMEM, file IO and checkpoints
# ---------------------------------------------------------------------------

PS_ELEMS = 64 * MIB // 4  # a parameter-server window's rank slice: 64 MiB f32
PS_CLOSES = 10  # fence epochs: 1 interpreted, 1 capture, 8 replays
KV_ELEMS = 16 * MIB // 2  # the bf16 cache window's rank slice: 16 MiB
KV_PUTS = 32  # indexed puts per cache epoch
KV_CLOSES = 6
AMO_CALLS = 1024
AMO_ELEMS = 1 << 20
#: bench.py's rma_steady sizes (bench.py:1116-1190), then the PS slice
RMA_BYTES = (4 << 10, 64 << 10, 256 << 10, 64 * MIB)
SHMEM_BYTES = (4 << 10, 64 << 10)
IO_BLOCK_ELEMS = 32 * MIB // 4  # a rank's File block: 32 MiB f32
CLOSE_SAMPLES = 100  # host µs samples per leg, each close from an idle card


def osc_plans_are_graphs(win, what, racy=False):
    """Every epoch plan of ``win`` replays as a CUDA graph. Where threads
    race to queue ops (``racy``), a batch of several contenders' ops can
    close together once and freeze a plan that never replays (its one
    close ran interpreted, as every first close does): such plans are
    allowed, every replayed plan must still be a graph, and at least one
    plan must have replayed."""
    plans = list(win._access_plans.values())
    check(plans, f"{what}: no epoch plan frozen")
    for p in plans:
        check(p.bad is None, f"{what}: an epoch plan is not a CUDA graph: "
                             f"{p.bad}")
        if racy and p.prog is None:
            continue
        check(p.graph is not None,
              f"{what}: an epoch plan is not a CUDA graph: "
              + ("never replayed" if p.prog is None else "none captured"))
    check(any(p.graph is not None for p in plans),
          f"{what}: no epoch plan replayed as a CUDA graph")


def osc_hits():
    from ompi_release_tpu_torch.mca import pvar as tpvar

    st = tpvar.PVARS.lookup("osc_plan_cache_hits").read()
    return int(st["count"]), int(st["sum"])


def with_osc_interpreted(tmvar, fn):
    """``fn()`` with ``osc_compiled`` false: every close interpreted."""
    tmvar.set_value("osc_compiled", False)
    try:
        return fn()
    finally:
        tmvar.VARS.unset("osc_compiled")


def s8_param_server(world, tmvar, torch, dev):
    """A window of 8 x 64 MiB f32: each fence epoch accumulates 7 fresh
    64 MiB gradients into rank 0, then gets it. The planned leg (close 1
    interpreted, close 2 captures, closes 3-10 replay) against the
    interpreted leg and the sums taken in the same order on the host,
    bitwise."""
    import numpy as np

    from ompi_release_tpu_torch.osc import win_allocate

    def run():
        g = torch.Generator(device=dev).manual_seed(90)
        w = win_allocate(world, (PS_ELEMS,))
        reads, hosts = [], []
        w.fence()
        for _ in range(PS_CLOSES):
            grads = torch.randn(N_RANKS - 1, PS_ELEMS, generator=g,
                                device=dev)
            for r in range(1, N_RANKS):
                w.accumulate(grads[r - 1], target=0)
            get = w.get(target=0)
            w.fence()
            reads.append(get.value)
            hosts.append(grads.cpu().numpy())
        w.fence_end()
        return w, reads, hosts

    wi, want, hosts = with_osc_interpreted(tmvar, run)
    c0, s0 = osc_hits()
    wc, got, _ = run()
    c1, s1 = osc_hits()
    osc_plans_are_graphs(wc, "parameter-server epoch")
    check((c1 - c0, s1 - s0) == (PS_CLOSES, PS_CLOSES - 1),
          f"parameter-server closes: {c1 - c0} planned, {s1 - s0} replays")
    ref = np.zeros(PS_ELEMS, np.float32)
    for k, (a, b) in enumerate(zip(got, want)):
        for row in hosts[k]:
            ref = ref + row
        check(bits_equal(a, b), f"parameter-server close {k}: plan != "
                                "interpreted")
        check(np.array_equal(a.cpu().numpy().view(np.int32),
                             ref.view(np.int32)),
              f"parameter-server close {k} != the host's sums")
    check(bits_equal(wc.read(), wi.read()), "parameter-server windows differ")
    wi.free()
    wc.free()
    log(f"slice 8: parameter-server window (8 x 64 MiB f32): {PS_CLOSES} "
        f"fence epochs of 7 accumulates + a get, {s1 - s0} graph replays, "
        "bitwise the interpreted closes and the host's sums")


def s8_kv_fill(world, tmvar, torch, dev):
    """A (8, 16 MiB) bf16 window filled by indexed puts (a page of a KV
    cache per epoch) in lock epochs on rank 3 and PSCW epochs on rank 5,
    each epoch read back by a get: planned against interpreted,
    bitwise; the window holds the last epoch's values."""
    from ompi_release_tpu_torch.osc import win_allocate

    pos = [j * (KV_ELEMS // KV_PUTS) + 17 for j in range(KV_PUTS)]

    def run():
        g = torch.Generator(device=dev).manual_seed(91)
        w = win_allocate(world, (KV_ELEMS,), torch.bfloat16)
        reads = []
        for k in range(2 * KV_CLOSES):
            vals = torch.randn(KV_PUTS, generator=g,
                               device=dev).to(torch.bfloat16)
            lock = k < KV_CLOSES
            t = 3 if lock else 5
            if lock:
                w.lock(t)
            else:
                w.post(world.group)
                w.start(world.group)
            for j, i in enumerate(pos):
                w.put(vals[j], target=t, index=i)
            get = w.get(target=t)
            if lock:
                w.unlock(t)
            else:
                w.complete()
                w.wait()
            reads.append(get.value)
        return w, reads, vals

    wi, want, _ = with_osc_interpreted(tmvar, run)
    wc, got, last = run()
    osc_plans_are_graphs(wc, "KV-cache fill")
    check(len(wc._access_plans) == 2, "KV-cache fill: one plan per epoch kind")
    check(all(bits_equal(a, b) for a, b in zip(got, want)),
          "KV-cache fill: a planned read != the interpreted one")
    final = wc.read()
    check(bits_equal(final, wi.read()), "KV-cache windows differ")
    check(bits_equal(final[5, pos], last), "KV-cache page != the last puts")
    wi.free()
    wc.free()
    log(f"slice 8: KV-cache fill (8 x 16 MiB bf16): {2 * KV_CLOSES} lock and "
        f"PSCW epochs of {KV_PUTS} indexed puts + a get, graphs, bitwise the "
        "interpreted closes")


def s8_amo_loop(world, torch, dev):
    """1,024 fetch_and_op(SUM) and 1,024 compare_and_swap calls, each
    flushed, on one int32 element of a (8, 2^20) window, against the
    closed form."""
    import numpy as np

    from ompi_release_tpu_torch import ops as tops
    from ompi_release_tpu_torch.osc import win_allocate

    w = win_allocate(world, (AMO_ELEMS,), torch.int32)
    w.lock_all()
    fetched, swapped = [], []
    t0 = time.perf_counter()
    for _ in range(AMO_CALLS):
        req = w.fetch_and_op(np.int32(3), 6, op=tops.SUM, index=12345)
        w.flush(6)
        fetched.append(req.value)
    for k in range(AMO_CALLS):
        req = w.compare_and_swap(np.int32(k + 1), np.int32(k), 2, index=777)
        w.flush(2)
        swapped.append(req.value)
    host_s = time.perf_counter() - t0
    w.unlock_all()
    got_f = torch.stack(fetched).cpu().numpy()
    got_s = torch.stack(swapped).cpu().numpy()
    k = np.arange(AMO_CALLS, dtype=np.int32)
    check(np.array_equal(got_f, 3 * k), "fetch_and_op values != 3k")
    check(np.array_equal(got_s, k), "compare_and_swap values != k")
    data = w.read()
    check(int(data[6, 12345]) == 3 * AMO_CALLS
          and int(data[2, 777]) == AMO_CALLS
          and int(data.sum()) == 4 * AMO_CALLS, "AMO window != closed form")
    osc_plans_are_graphs(w, "scalar AMO loop")
    w.free()
    log(json.dumps({"amo_loop_host_us_per_call":
                    host_s / (2 * AMO_CALLS) * 1e6}))
    log(f"slice 8: {AMO_CALLS} fetch_and_op(SUM) + {AMO_CALLS} "
        "compare_and_swap on one int32 element equal the closed form")


def s8_shmem(comm, tmvar, cuda_op, torch, dev):
    """SHMEM on a tuned comm: a (8, 16 MiB) f32 heap through the bulk
    path equals the per-call path on every PE; sum_to_all at 64 MiB a PE
    equals the op ^cuda call and launches the SUM kernel; 4 threads
    contending for one lock keep mutual exclusion."""
    import threading

    from ompi_release_tpu_torch.oshmem import ShmemCtx

    ctx = ShmemCtx(comm)
    elems = 16 * MIB // 4

    def heap_rounds(bulk):
        tmvar.set_value("shmem_bulk", bulk)
        try:
            g = torch.Generator(device=dev).manual_seed(92)
            sym = ctx.malloc((elems,))
            for _ in range(4):
                vals = torch.randn(N_RANKS, elems, generator=g, device=dev)
                bump = torch.randn(N_RANKS, elems, generator=g, device=dev)
                for pe in range(N_RANKS):
                    ctx.put(sym, vals[pe], pe=pe)
                    ctx.atomic_add(sym, bump[pe], pe=pe)
                ctx.quiet()
            heaps = [sym.local(pe) for pe in range(N_RANKS)]
            osc_plans_are_graphs(sym._win, f"SHMEM heap (bulk {bulk})")
            sym.free()
            return heaps
        finally:
            tmvar.VARS.unset("shmem_bulk")

    per_call, bulk = heap_rounds(False), heap_rounds(True)
    check(all(bits_equal(a, b) for a, b in zip(bulk, per_call)),
          "SHMEM bulk heap != the per-call heap")
    del per_call, bulk
    x = torch.randn(N_RANKS, 64 * MIB // 4, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(93))
    before = sum_folds(cuda_op)
    outs = [ctx.sum_to_all(x) for _ in range(3)]
    sum_launches = sum_folds(cuda_op) - before
    plain = with_op_excluded(tmvar, lambda: ctx.sum_to_all(x))
    check(all(bits_equal(o, plain) for o in outs),
          "sum_to_all at 64 MiB != the op ^cuda call")
    check(sum_launches > 0, "sum_to_all launched no stream_axpy[sum] and no "
                            "ring_fold")
    del outs, plain, x
    lk = ctx.lock_create()
    counter = ctx.malloc((1,), torch.int32)
    errs = []

    def contender(pe):
        try:
            for _ in range(25):
                ctx.set_lock(lk, pe=pe)
                try:
                    v = int(ctx.atomic_fetch(counter, pe=0).reshape(-1)[0])
                    ctx.atomic_set(counter, v + 1, pe=0)
                finally:
                    ctx.clear_lock(lk, pe=pe)
        except Exception as e:  # surfaced after join
            errs.append(e)

    threads = [threading.Thread(target=contender, args=(pe,))
               for pe in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    check(not any(th.is_alive() for th in threads) and not errs,
          f"lock contention: {errs}")
    final = int(ctx.atomic_fetch(counter, pe=0).reshape(-1)[0])
    check(final == 100, f"4 x 25 locked increments gave {final}")
    osc_plans_are_graphs(lk._win, "SHMEM lock word", racy=True)
    osc_plans_are_graphs(counter._win, "SHMEM locked counter")
    lock_plans = list(lk._win._access_plans.values())
    once = sum(p.prog is None for p in lock_plans)
    ctx.finalize()
    log(f"slice 8: SHMEM (8 x 16 MiB f32 heap) bulk == per-call on every PE; "
        f"sum_to_all at 64 MiB == op ^cuda ({sum_launches} SUM or ring_fold "
        "launches); "
        "4-thread lock contention kept 100 increments; lock-word plans: "
        f"{len(lock_plans) - once} graphs, {once} batches of racing CASes "
        "closed once")


def s8_io(world, torch, dev, tmp):
    """File.write_at_all of 8 x 32 MiB card blocks under a vector view
    (half of each tile a hole), read back bitwise; save_sharded /
    load_sharded of a 256 MiB f32 card tensor, bitwise."""
    import os

    import numpy as np

    from ompi_release_tpu_torch.datatype import datatype as tdt
    from ompi_release_tpu_torch.io import File, load_sharded, save_sharded

    x = torch.randn(N_RANKS, IO_BLOCK_ELEMS, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(94))
    ft = tdt.create_vector(8, IO_BLOCK_ELEMS // 8, IO_BLOCK_ELEMS // 4,
                           tdt.FLOAT)
    path = os.path.join(tmp, "blocks.bin")
    offsets = [r * IO_BLOCK_ELEMS for r in range(N_RANKS)]
    with File(world, path) as f:
        f.set_view(0, np.float32, filetype=ft)
        f.write_at_all(offsets, [x[r] for r in range(N_RANKS)])
        back = f.read_at_all(offsets, [IO_BLOCK_ELEMS] * N_RANKS)
    host = x.cpu().numpy()
    check(all(np.array_equal(b.view(np.int32), host[r].view(np.int32))
              for r, b in enumerate(back)), "File read-back != the blocks")
    raw = np.fromfile(path, np.float32)
    run = IO_BLOCK_ELEMS // 8
    check(np.array_equal(raw[:run].view(np.int32),
                         host[0, :run].view(np.int32))
          and np.array_equal(raw[2 * run:3 * run].view(np.int32),
                             host[0, run:2 * run].view(np.int32)),
          "the vector view did not place the runs")
    save_sharded(os.path.join(tmp, "arr"), x, name="x")
    y = load_sharded(os.path.join(tmp, "arr"), name="x")
    check(bits_equal(y, x.cpu()), "save_sharded/load_sharded of 256 MiB")
    log("slice 8: File.write_at_all of 8 x 32 MiB under a vector view and "
        "a 256 MiB save_sharded/load_sharded read back bitwise")


def phase_slice8(world, tmvar, cuda_op, torch, dev):
    """Slice 8's path with every launch counter at 0 before it; returns
    the SUM launches it made. SHMEM runs on a tuned comm of its own,
    freed with its collectives' graphs at the end."""
    import tempfile

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_op.reset_launches()
    s8_param_server(world, tmvar, torch, dev)
    s8_kv_fill(world, tmvar, torch, dev)
    s8_amo_loop(world, torch, dev)
    shm = comm_with(world, tmvar, "tuned")
    s8_shmem(shm, tmvar, cuda_op, torch, dev)
    shm.free()
    with tempfile.TemporaryDirectory() as tmp:
        s8_io(world, torch, dev, tmp)
    torch.cuda.synchronize()
    launches = dict(cuda_op.LAUNCHES)
    log(f"phase 3: slice-8 path launches {launches}")
    check(sum_folds(cuda_op) > 0, "neither the sum wrapper nor ring_fold "
                                  "launched on the slice-8 path")
    log(json.dumps({"slice8_peak_memory_GiB":
                    torch.cuda.max_memory_allocated(dev) / 2 ** 30}))
    log(f"slice 8: checks took {time.perf_counter() - t0:.1f} s")
    return launches["sum"]


def time_slice8(world, tmvar, torch, dev):
    """Slice 8's timings (not gates), each line with the card: epoch-close
    ms and host µs per close, replayed plan against the interpreted close
    in turns, with osc_orchestration_seconds per close, at bench.py's
    rma_steady sizes and 64 MiB; a profiler window of 64 MiB replays;
    SHMEM bulk against per-call rounds; File and sharded GB/s; the peak
    memory."""
    import os
    import tempfile

    from ompi_release_tpu_torch.io import File, load_sharded, save_sharded
    from ompi_release_tpu_torch.mca import pvar as tpvar
    from ompi_release_tpu_torch.oshmem import ShmemCtx
    from ompi_release_tpu_torch.osc import win_allocate

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    card = card_line()
    orch = tpvar.PVARS.lookup("osc_orchestration_seconds")
    g = torch.Generator(device=dev).manual_seed(95)
    rma = {}
    for nbytes in RMA_BYTES:
        elems = nbytes // 4
        w = win_allocate(world, (elems,))
        pay = torch.randn(elems, generator=g, device=dev)
        acc = torch.randn(elems, generator=g, device=dev)

        def queue():
            w.lock(1)
            w.put(pay, target=1)
            w.accumulate(acc, target=1)
            return w.get(target=1)

        def replayed():
            queue()
            w.unlock(1)

        def interpreted_close():
            queue()
            with w._op_lock:
                w._run_epoch_program(w._take_pending(1),
                                     _t0=time.perf_counter())
            w.unlock(1)

        legs = {"replayed": replayed, "interpreted": interpreted_close}
        for fn in legs.values():  # the plan frozen, captured, replayed
            for _ in range(3):
                fn()
        ms = turns_ms(legs, reps=TIMING_REPS)
        host, orch_us = {}, {}
        for name in legs:
            samples, spans = [], []
            for _ in range(CLOSE_SAMPLES):
                queue()
                torch.cuda.synchronize()
                o0 = orch.read()
                t1 = time.perf_counter()
                if name == "replayed":
                    w.unlock(1)
                else:
                    with w._op_lock:
                        w._run_epoch_program(w._take_pending(1),
                                             _t0=time.perf_counter())
                    w.unlock(1)
                samples.append((time.perf_counter() - t1) * 1e6)
                spans.append((orch.read() - o0) * 1e6)
            orch_us[name] = statistics.median(spans)
            host[name] = statistics.median(samples)
        torch.cuda.synchronize()
        osc_plans_are_graphs(w, f"timed epoch at {nbytes} B")
        rma[nbytes] = {"epoch_ms": ms, "close_host_us": host,
                       "orchestration_us_per_close": orch_us}
        if nbytes == RMA_BYTES[-1]:
            log(json.dumps({"profile_replayed_epoch_64MiB":
                            tbench.profile_window(replayed, 3)}))
        w.free()
        del w, pay, acc
    log(json.dumps({"rma_put_acc_get_plan_vs_interpreted": rma,
                    "card": card}))
    ctx = ShmemCtx(world)
    shm = {}
    for nbytes in SHMEM_BYTES:
        elems = nbytes // 4
        vals = torch.randn(N_RANKS, elems, generator=g, device=dev)
        bump = torch.full((elems,), 0.5, device=dev)
        for bulk in (False, True):
            tmvar.set_value("shmem_bulk", bulk)
            try:
                sym = ctx.malloc((elems,))
                rounds = []
                for r in range(12):
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    for pe in range(N_RANKS):
                        ctx.put(sym, vals[pe], pe=pe)
                        ctx.atomic_add(sym, bump, pe=pe)
                    ctx.quiet()
                    torch.cuda.synchronize()
                    if r >= 2:  # after the plan's capture
                        rounds.append((time.perf_counter() - t1) * 1e3)
                sym.free()
            finally:
                tmvar.VARS.unset("shmem_bulk")
            shm.setdefault(nbytes, {})["bulk" if bulk else "per_call"] = \
                statistics.median(rounds)
    ctx.finalize()
    log(json.dumps({"shmem_round_ms_8_puts_8_adds": shm, "card": card}))
    x = torch.randn(N_RANKS, IO_BLOCK_ELEMS, generator=g, device=dev)
    nbytes = x.numel() * 4
    io = {}
    with tempfile.TemporaryDirectory() as tmp:
        import numpy as np

        offsets = [r * IO_BLOCK_ELEMS for r in range(N_RANKS)]
        with File(world, os.path.join(tmp, "f.bin")) as f:
            f.set_view(0, np.float32)
            t1 = time.perf_counter()
            f.write_at_all(offsets, [x[r] for r in range(N_RANKS)])
            io["file_write_GBps"] = nbytes / (time.perf_counter() - t1) / 1e9
            t1 = time.perf_counter()
            f.read_at_all(offsets, [IO_BLOCK_ELEMS] * N_RANKS)
            io["file_read_GBps"] = nbytes / (time.perf_counter() - t1) / 1e9
        t1 = time.perf_counter()
        save_sharded(os.path.join(tmp, "a"), x, name="x")
        io["sharded_save_GBps"] = nbytes / (time.perf_counter() - t1) / 1e9
        t1 = time.perf_counter()
        load_sharded(os.path.join(tmp, "a"), name="x").to(dev)
        torch.cuda.synchronize()
        io["sharded_load_GBps"] = nbytes / (time.perf_counter() - t1) / 1e9
    del x
    log(json.dumps({"io_256MiB": io, "card": card}))
    log(json.dumps({"slice8_timings_peak_memory_GiB":
                    torch.cuda.max_memory_allocated(dev) / 2 ** 30}))
    log(f"slice 8: timings took {time.perf_counter() - t0:.1f} s")


def s8_checkpoint(model, torch):
    """A Checkpointer save (async) and restore of the full-width TpuLM's
    parameters and AdamW state, from the card and back, bitwise; a train
    step runs in place between the save and its wait, and the restore is
    the state at the save. Files go in a temporary directory."""
    import tempfile

    from ompi_release_tpu_torch import entry as tentry
    from ompi_release_tpu_torch.ft import Checkpointer

    opt = model.opt_state
    check(opt is not None, "the train path left no AdamW state")
    p = model.params()
    flat = {**{n: t for n, t in p.items() if n != "layers"},
            **{f"layers.{n}": t for n, t in p["layers"].items()}}
    live = {"params": {n: t.detach() for n, t in flat.items()}}
    for key in ("exp_avg", "exp_avg_sq", "step"):
        live[key] = {n: opt.state[t][key] for n, t in flat.items()}
    want = {k: {n: t.clone() for n, t in d.items()} for k, d in live.items()}
    first = next(iter(flat))
    nbytes = sum(t.numel() * t.element_size()
                 for d in want.values() for t in d.values())
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(1, live, async_=True)
        save_return_s = time.perf_counter() - t0
        tentry.run_train(model, 1)  # updates params and AdamW state in place
        ck.wait()
        save_s = time.perf_counter() - t0
        changed = not bits_equal(live["params"][first],
                                 want["params"][first])
        t0 = time.perf_counter()
        got = ck.restore(want)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    check(changed, "the train step between save and wait changed nothing")
    for k, d in want.items():
        for n, t in d.items():
            check(got[k][n].device == t.device and bits_equal(got[k][n], t),
                  f"checkpoint restore of {k}/{n} != the state at the save")
    log(json.dumps({"checkpoint_tpulm_adamw": {
        "state_MiB": nbytes / MIB, "leaves": sum(len(d) for d in want.values()),
        "save_returns_ms": save_return_s * 1e3,
        "save_commit_s": save_s, "restore_s": restore_s,
        "save_GBps": nbytes / save_s / 1e9,
        "restore_GBps": nbytes / restore_s / 1e9}, "card": card_line()}))
    log("slice 8: Checkpointer async save + restore of the full-width TpuLM's "
        "parameters and AdamW state, card to card, bitwise the state at the "
        "save (a train step ran in place before the wait)")


# ---------------------------------------------------------------------------
# slice 9: the parallelism strategies at axes > 1 — the full-width TpuLM
# train step sharded over 8 virtual ranks, the Mixer at dp x tp, and the
# whole-tree passes
# ---------------------------------------------------------------------------

#: dryrun_multichip(8)'s two factorizations (__graft_entry__.py:133-162)
MESH_A = dict(dp=2, pp=2, tp=2)  # dense, microbatches 2
MESH_B = dict(dp=2, sp=2, ep=2)  # 4 experts, capacity factor 4.0
S9_TRAIN_A = 4  # mesh A: 1 eval batch + 4 train steps
S9_TRAIN_B = 3  # mesh B: 1 eval batch + 3 train steps
#: the one-card MoE reference runs its (8, 2048) batch as 8 microbatches
#: of one sequence: at capacity factor 4.0 no token is dropped either
#: way (capacity = tokens per call), so the loss is the same function,
#: and each call's (T, E, C) dispatch is mesh B's per-rank one
MOE_REF_MICROBATCHES = 8
#: flash launches of one mesh-A forward: (M + S - 1) ticks x L / S layers
#: of the pp-stacked stage, each one launch over all ranks
S9_FLASH_PER_FWD = (2 + 2 - 1) * (8 // 2)
#: the most relative L2 gap of any leaf's full-width f32 gradient between
#: a mesh and the one-card model (s9_grads_close): sound runs on an H100
#: read 8e-7 to 4.0e-6, a gradient of the wrong magnitude (2x) about 1
S9_GRAD_REL = 1e-4
#: rows of the (rows, 2048) batch of that gradient comparison
S9_GRAD_ROWS = 4


def s9_losses_close(got, want, what):
    """Step 1 within rel 1e-4, step 2 within rel 1e-3 / abs 1e-4 (the
    bounds of tests/test_models.py:88, 96-97)."""
    check(all(map(math.isfinite, got)), f"{what}: losses {got}")
    check(abs(got[0] - want[0]) <= 1e-4 * abs(want[0]),
          f"{what}: step-1 loss {got[0]} vs the one-card {want[0]} "
          "(rel 1e-4)")
    check(abs(got[1] - want[1]) <= max(1e-3 * abs(want[1]), 1e-4),
          f"{what}: step-2 loss {got[1]} vs the one-card {want[1]} "
          "(rel 1e-3, abs 1e-4)")


def s9_grads_close(torch, axes, cfg, ref_cfg, what):
    """Every leaf's gradient of the loss at full width in f32 (TF32 off),
    sharded over ``axes``, against the one-card model's (``ref_cfg``)
    from the same seed-0 weights on the same (S9_GRAD_ROWS, 2048) batch:
    the relative L2 gap of each leaf within S9_GRAD_REL. The loss gates
    see AdamW's first update, about lr * sign(g), so they miss a gradient
    of the wrong magnitude; this gate does not, and the same gaps with
    the sharded gradients scaled by 2 must exceed it. f32, because bf16's
    rounding (and the MoE routing flips it causes) puts a floor of 1e-2
    to 1e-1 under the gaps; the transposes it checks are the same in
    either dtype. Returns (worst gap, its leaf, the least gap at 2x)."""
    import dataclasses

    from ompi_release_tpu_torch import entry as tentry
    from ompi_release_tpu_torch.models import transformer as tfm
    from ompi_release_tpu_torch.optim import leaves
    from ompi_release_tpu_torch.parallel.mesh_axes import build_parallel_mesh

    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    ref_cfg = dataclasses.replace(ref_cfg, dtype=torch.float32)
    mesh = build_parallel_mesh(**axes)
    base = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    tok, tgt = (torch.as_tensor(a, device=mesh.device) for a in tentry._batch(
        cfg, S9_GRAD_ROWS, tentry.EVAL_SEQ))

    def names(params, prefix=""):
        out = []
        for k in sorted(params):
            v = params[k]
            out.extend(names(v, f"{prefix}{k}.") if isinstance(v, dict)
                       else [prefix + k])
        return out

    def grads(loss_fn):
        params = copy_params(base, mesh.device)
        ts = leaves(params)
        for p in ts:
            p.requires_grad_(True)
        return [g.float() for g in torch.autograd.grad(loss_fn(params), ts)]

    got = grads(lambda p: tfm.sharded_loss(cfg, mesh, p, tok, tgt))
    want = grads(lambda p: tfm.forward_loss(ref_cfg, p, tok, tgt))

    def gaps(scale):
        return [float((scale * a - b).norm() / b.norm())
                for a, b in zip(got, want)]

    rel, planted = gaps(1.0), gaps(2.0)
    leaf = names(base)
    worst = max(range(len(rel)), key=rel.__getitem__)
    log(json.dumps({f"s9_grads_{what}": dict(zip(leaf, rel)),
                    "limit": S9_GRAD_REL, "least_gap_at_2x": min(planted)}))
    check(max(rel) <= S9_GRAD_REL,
          f"{what}: gradient of {leaf[worst]} relative L2 {rel[worst]} vs "
          f"the one-card model's (> {S9_GRAD_REL})")
    check(min(planted) > S9_GRAD_REL,
          f"{what}: a 2x gradient passes the gate ({min(planted)})")
    del got, want
    torch.cuda.empty_cache()
    return rel[worst], leaf[worst], min(planted)


def s9_mesh(torch, axes, cfg, n_train, ref_cfg, cuda_op):
    """One mesh's path: the sharded TpuLM's eval batch and ``n_train``
    steps (launch counts read around exactly them), then the one-card
    model from the same seed-0 weights on the same batch for 2 steps.
    Returns (model, evals, steps, launches, ref_losses, peak GiB)."""
    from ompi_release_tpu_torch import entry as tentry
    from ompi_release_tpu_torch.models.transformer import TpuLM
    from ompi_release_tpu_torch.parallel.mesh_axes import build_parallel_mesh

    mesh = build_parallel_mesh(**axes)
    check(mesh.size == 8 and mesh.device.type == "cuda",
          f"mesh {axes}: {mesh.size} ranks on {mesh.device}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = TpuLM(cfg, seed=0, mesh=mesh)
    torch.cuda.synchronize()
    cuda_op.reset_launches()
    evals = tentry.run_eval(model, n_batches=1)
    steps = tentry.run_train(model, n_train)
    torch.cuda.synchronize()
    launches = dict(cuda_op.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ref = TpuLM(ref_cfg, seed=0)
    ref_losses = [loss for loss, _ in tentry.run_train(ref, 2)]
    del ref
    torch.cuda.empty_cache()
    return model, evals, steps, launches, ref_losses, peak


def s9_mixer(torch):
    """The full-width Mixer at dp = 2, tp = 2: two ``sgd(0.1)`` steps
    against the one-card Mixer from the same weights, f32 (TF32 off)
    within rel 1e-4 and the default bf16 within rel 1e-2."""
    import dataclasses

    from ompi_release_tpu_torch import entry as tentry
    from ompi_release_tpu_torch.models import mixer as mx
    from ompi_release_tpu_torch.optim import sgd
    from ompi_release_tpu_torch.parallel.mesh_axes import build_parallel_mesh

    out = {}
    for dtype, rtol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        cfg = dataclasses.replace(mx.MixerConfig(), dtype=dtype)
        base = mx.init_params(cfg, torch.Generator().manual_seed(0))
        patches, labels = tentry.mixer_batch(cfg)

        def run(axes):
            mesh = build_parallel_mesh(**axes)
            params = copy_params(base, mesh.device)
            step = mx.make_train_step(cfg, mesh)
            state = sgd(tentry.MIXER_LR)(params)
            return [float(step(params, state, patches, labels)[2])
                    for _ in range(2)]

        one, sharded = run({}), run(dict(dp=2, tp=2))
        name = str(dtype)[6:]
        out[name] = {"dp2xtp2": sharded, "one_card": one}
        for a, b in zip(sharded, one):
            check(abs(a - b) <= rtol * abs(b),
                  f"Mixer {name} at dp2 x tp2: losses {sharded} vs the "
                  f"one-card {one} (rel {rtol})")
        check(sharded[1] < sharded[0], f"Mixer {name} loss did not fall")
    log(json.dumps({"s9_mixer_dp2xtp2_vs_one_card": out}))
    return out


def s9_tree_passes(tmvar, cuda_op, torch, dev):
    """tree_allreduce / tree_reduce_scatter / tree_allgather over the
    full-width TpuLM's 66 gradients stacked on dp = 8 virtual ranks:
    the planned passes (default buckets) bitwise the per-leaf folds
    (``bucket_bytes=0``) and the ``--mca op ^cuda`` run; the allgather
    of the reduce-scatter's shards bitwise the allreduce (one fold
    order). Returns the SUM launches of the planned passes."""
    from ompi_release_tpu_torch.parallel import tree
    from ompi_release_tpu_torch.parallel.mesh_axes import ParallelMesh

    mesh = ParallelMesh(shape={"dp": N_RANKS}, device=dev)
    grads = {f"g{i:02d}": g for i, g in enumerate(
        grad_list(torch, dev, integer=False))}
    shapes = {k: tuple(v.shape[1:]) for k, v in grads.items()}

    def passes(bb):
        with mesh:
            ar = tree.tree_allreduce(grads, "dp", bucket_bytes=bb)
            rs = tree.tree_reduce_scatter(grads, "dp", mean=False,
                                          bucket_bytes=bb)
            ag = tree.tree_allgather(rs, shapes, "dp", bucket_bytes=bb)
        return ar, rs, ag

    cuda_op.reset_launches()
    planned = passes(None)
    torch.cuda.synchronize()
    sums = cuda_op.LAUNCHES["sum"]
    perleaf = passes(0)
    plain = with_op_excluded(tmvar, lambda: passes(None))
    for kind, p, q, r in zip(("allreduce", "reduce_scatter", "allgather"),
                             planned, perleaf, plain):
        for k in grads:
            check(bits_equal(p[k], q[k]), f"tree_{kind} {k}: planned != "
                                          "per-leaf (bitwise)")
            check(bits_equal(p[k], r[k]), f"tree_{kind} {k}: != op ^cuda "
                                          "(bitwise)")
    for k in grads:
        check(bits_equal(planned[2][k], planned[0][k]),
              f"{k}: allgather(reduce_scatter) != allreduce (bitwise)")
    check(sums > 0, "the tree passes launched no stream_axpy[sum]")
    nbytes = sum(g.numel() * g.element_size() for g in grads.values())
    log(json.dumps({"s9_tree_passes": {
        "leaves": len(grads), "ranks": N_RANKS, "MiB": nbytes / MIB,
        "sum_launches": sums}}))
    return sums


def phase_slice9(tmvar, cuda_op, torch, dev):
    """Slice 9's path: the full-width TpuLM train step sharded over the
    8 virtual ranks of dryrun_multichip's two factorizations, each
    against the one-card model from the same weights; the Mixer at dp x
    tp; the whole-tree passes. Returns the models and the launches."""
    import dataclasses

    from ompi_release_tpu_torch.models.transformer import ModelConfig

    t0 = time.perf_counter()
    cfg_a = ModelConfig(microbatches=2)
    model_a, evals_a, steps_a, la, ref_a, peak_a = s9_mesh(
        torch, MESH_A, cfg_a, S9_TRAIN_A, cfg_a, cuda_op)
    losses_a = [x for x, _ in steps_a]
    want = {"flash_fwd": S9_FLASH_PER_FWD * (1 + S9_TRAIN_A),
            "flash_bwd_dq": S9_FLASH_PER_FWD * S9_TRAIN_A,
            "flash_bwd_dkv": S9_FLASH_PER_FWD * S9_TRAIN_A}
    for name, n in want.items():
        check(la[name] == n, f"mesh A: {name} launched {la[name]} times, "
                             f"not {n} ({S9_FLASH_PER_FWD} a forward)")
    check(la["sum"] > 0, "mesh A: stream_axpy[sum] launched no time")
    check(abs(evals_a[0][0] - math.log(cfg_a.vocab)) < 1.0,
          f"mesh A eval loss {evals_a[0][0]} not near ln(32000)")
    check(losses_a[-1] < losses_a[0], f"mesh A losses {losses_a} not falling")
    s9_losses_close(losses_a, ref_a, "mesh A (dp2 x pp2 x tp2)")
    log(json.dumps({"s9_mesh_a": MESH_A, "eval_loss": evals_a[0][0],
                    "train_losses": losses_a, "one_card_losses": ref_a,
                    "launches": la, "peak_device_memory_GiB": peak_a}))
    del model_a
    torch.cuda.empty_cache()
    grad_a = s9_grads_close(torch, MESH_A, cfg_a, cfg_a, "mesh_a")

    cfg_b = ModelConfig(n_experts=MOE_EXPERTS, capacity_factor=4.0)
    ref_b_cfg = ModelConfig(n_experts=MOE_EXPERTS, capacity_factor=4.0,
                            microbatches=MOE_REF_MICROBATCHES)
    model_b, evals_b, steps_b, lb, ref_b, peak_b = s9_mesh(
        torch, MESH_B, cfg_b, S9_TRAIN_B, ref_b_cfg, cuda_op)
    losses_b = [x for x, _ in steps_b]
    check(lb["flash_fwd"] == 0, "mesh B (sp = 2) must take ring attention")
    check(abs(evals_b[0][0] - math.log(cfg_b.vocab)) < 1.0,
          f"mesh B eval loss {evals_b[0][0]} not near ln(32000)")
    check(losses_b[-1] < losses_b[0], f"mesh B losses {losses_b} not falling")
    s9_losses_close(losses_b, ref_b, "mesh B (dp2 x sp2 x ep2, MoE)")
    log(json.dumps({"s9_mesh_b": MESH_B, "eval_loss": evals_b[0][0],
                    "train_losses": losses_b, "one_card_losses": ref_b,
                    "launches": lb, "peak_device_memory_GiB": peak_b}))
    del model_b
    torch.cuda.empty_cache()
    grad_b = s9_grads_close(  # the reference: one sequence a microbatch
        torch, MESH_B, cfg_b,
        dataclasses.replace(ref_b_cfg, microbatches=S9_GRAD_ROWS), "mesh_b")

    s9_mixer(torch)
    tree_sums = s9_tree_passes(tmvar, cuda_op, torch, dev)
    log(f"phase 3: slice-9 path: mesh A {la['flash_fwd']} / "
        f"{la['flash_bwd_dq']} / {la['flash_bwd_dkv']} flash launches, "
        f"{la['sum']} SUM launches; meshes A and B == the one-card steps "
        "(rel 1e-4 / 1e-3), gradients within relative L2 "
        f"{grad_a[0]:.2e} ({grad_a[1]}) / {grad_b[0]:.2e} ({grad_b[1]}) "
        f"(2x: >= {min(grad_a[2], grad_b[2]):.2f}); "
        "Mixer dp2 x tp2 == one card; tree passes "
        f"bitwise ({time.perf_counter() - t0:.1f} s)")
    return {"mesh_a": la, "mesh_b": lb, "tree_sum": tree_sums}


def time_slice9(torch):
    """Each mesh's train step beside the one-card dense step, in turns
    (CUDA events, median of 3 after a warm-up round): ms per step and
    tokens/s, the peak memory of each mesh's window, and one profiler
    window per mesh step (busy share, top kernels, host gaps)."""
    from ompi_release_tpu_torch import entry as tentry
    from ompi_release_tpu_torch.models.transformer import ModelConfig, TpuLM
    from ompi_release_tpu_torch.parallel.mesh_axes import build_parallel_mesh

    tok, tgt = (torch.as_tensor(a, device="cuda") for a in tentry._batch(
        ModelConfig(), tentry.EVAL_BATCH, tentry.EVAL_SEQ, seed=10))
    tokens = tentry.EVAL_BATCH * tentry.EVAL_SEQ
    one = TpuLM(ModelConfig(), seed=0)
    out = {}
    for label, axes, cfg in (
            ("mesh_a", MESH_A, ModelConfig(microbatches=2)),
            ("mesh_b", MESH_B, ModelConfig(n_experts=MOE_EXPERTS,
                                           capacity_factor=4.0))):
        torch.cuda.empty_cache()
        model = TpuLM(cfg, seed=0, mesh=build_parallel_mesh(**axes))
        torch.cuda.reset_peak_memory_stats()
        ms = turns_ms({label: lambda: model.train_step(tok, tgt),
                       "one_card": lambda: one.train_step(tok, tgt)},
                      reps=3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        prof = tbench.profile_window(lambda: model.train_step(tok, tgt), 1)
        out[label] = {"axes": axes, "ms_per_step": ms[label],
                      "tokens_per_s": tokens / (ms[label] * 1e-3),
                      "one_card_ms_per_step": ms["one_card"],
                      "vs_one_card": ms[label] / ms["one_card"],
                      "peak_device_memory_GiB_with_one_card": peak,
                      "profile": {**prof, "host_gap_ms": prof["window_ms"]
                                  - prof["device_busy_ms"]}}
        log(json.dumps({f"s9_time_{label}": out[label],
                        "card": card_line()}))
        del model
    del one
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# slice 10: the multi-process plane — a tpurun job of the port, COMM_WORLD
# spanning two worker processes on one card
# ---------------------------------------------------------------------------

S10_PROCS = 2
S10_RANKS = 4  # virtual ranks a worker owns on cuda:0
S10_N = S10_PROCS * S10_RANKS
#: the spanning allreduce sweep: 8 B by powers of 4 to 128 MiB, and 256
#: MiB, per rank
S10_SIZES = tuple(8 * 4 ** k for k in range(13)) + (256 * MIB,)
S10_ALGS = ("linear", "recursive_doubling", "ring", "rabenseifner")
S10_SCHED_BYTES = (MIB, 64 * MIB)
S10_PINGPONG = (MIB, 16 * MIB, 64 * MIB, 256 * MIB)
S10_DCN_BYTES = 64 * MIB


def s10_pattern(torch, count, rank, dev, dtype=None):
    """Rank ``rank``'s integer-valued row: exact under any fold order."""
    x = (torch.arange(count, device=dev) % 13 + rank).float()
    return x if dtype is None else x.to(dtype)


def s10_rows(torch, count, off, dev, dtype=None):
    """This worker's rank-stacked input: rows of its world ranks."""
    return torch.stack([s10_pattern(torch, count, off + i, dev, dtype)
                        for i in range(S10_RANKS)])


def s10_sum(torch, count, dev):
    """The closed form of the SUM over all ranks of ``s10_pattern``."""
    return (torch.arange(count, device=dev) % 13 * S10_N
            + S10_N * (S10_N - 1) // 2).float()


def s10_collectives(w, torch, off, dev):
    """The collective half of the worker's main path: yields each
    call's (name, output) as soon as the call returns."""
    for nbytes in S10_SIZES:
        yield (f"allreduce_{nbytes}",
               w.allreduce(s10_rows(torch, max(1, nbytes // 4), off, dev)))
    # bcast, allgather, reduce_scatter_block, alltoall at slice 1's
    # shapes per rank (f32 64 MiB, bf16 32 MiB, f32 128 MiB, int32 32 MiB)
    yield ("bcast", w.bcast(s10_rows(torch, 16 * MIB, off, dev), root=5))
    yield ("allgather", w.allgather(
        s10_rows(torch, 16 * MIB, off, dev, torch.bfloat16)))
    yield ("reduce_scatter_block", w.reduce_scatter_block(
        s10_rows(torch, 32 * MIB, off, dev)))
    a2a = torch.stack([
        torch.arange(8 * MIB, device=dev, dtype=torch.int32)
        + (off + i) * 8 * MIB for i in range(S10_RANKS)])
    yield ("alltoall", w.alltoall(a2a))


def s10_check_collectives(torch, outs, off, dev):
    """Every output against its closed form, bitwise."""
    for name, got in outs:
        if name.startswith("allreduce_"):
            count = max(1, int(name.split("_")[1]) // 4)
            want = s10_sum(torch, count, dev).expand(S10_RANKS, count)
        elif name == "bcast":
            want = s10_pattern(torch, 16 * MIB, 5, dev).expand(
                S10_RANKS, 16 * MIB)
        elif name == "allgather":
            want = torch.cat([s10_pattern(torch, 16 * MIB, r, dev,
                                          torch.bfloat16)
                              for r in range(S10_N)]).expand(
                S10_RANKS, S10_N * 16 * MIB)
        elif name == "reduce_scatter_block":
            full = s10_sum(torch, 32 * MIB, dev).view(S10_N, -1)
            want = full[off:off + S10_RANKS]
        else:  # alltoall: row b's chunk j is rank j's chunk for b
            c = MIB
            src = torch.arange(8 * MIB, device=dev,
                               dtype=torch.int32).view(S10_N, c)
            want = torch.stack([torch.cat([
                src[off + b] + j * 8 * MIB for j in range(S10_N)])
                for b in range(S10_RANKS)])
        check(bits_equal(got, want.contiguous()),
              f"slice 10: {name} differs from its closed form")


def s10_p2p(w, torch, off, dev, ring_tpu):
    """The point-to-point half: the ring over all 8 ranks, a 256 MiB send
    0 -> 5, an ssend 1 -> 6, a probe with ANY_SOURCE at rank 2."""
    res = {"ring": ring_tpu.ring_spanning(w)}
    count = P2P_BYTES // 4
    if off == 0:
        w.send(s10_pattern(torch, count, 0, dev), dest=5, tag=42, rank=0)
        w.send(torch.full((4,), 61.0, device=dev), dest=6, tag=43, rank=1,
               sync=True)
        st = None
        while st is None:
            st = w.iprobe(source=-1, tag=44, rank=2)
        got, st2 = w.recv(source=st.source, tag=44, rank=2)
        check(st.source == 4 and st2.source == 4
              and bits_equal(got, torch.full((3,), 4.0, device=dev)),
              f"slice 10: ANY_SOURCE probe saw {st.source}, got {got}")
    else:
        got, st = w.recv(source=0, tag=42, rank=5)
        check(st.source == 0 and got.device == dev
              and bits_equal(got, s10_pattern(torch, count, 0, dev)),
              "slice 10: the 256 MiB send 0 -> 5 differs")
        got, st = w.recv(source=1, tag=43, rank=6)
        check(bits_equal(got, torch.full((4,), 61.0, device=dev)),
              "slice 10: the ssend 1 -> 6 differs")
        w.send(torch.full((3,), 4.0, device=dev), dest=2, tag=44, rank=4)
    w.barrier()
    return res


def s10_schedules(w, tmvar, torch, off, dev):
    """Each hier inter schedule forced at 1 MiB and 64 MiB: bitwise the
    closed form, so bitwise each other."""
    for nbytes in S10_SCHED_BYTES:
        count = nbytes // 4
        outs = {}
        for alg in S10_ALGS:
            tmvar.set_value("hier_inter_algorithm", alg)
            try:
                outs[alg] = w.allreduce(s10_rows(torch, count, off, dev))
            finally:
                tmvar.VARS.unset("hier_inter_algorithm")
            check(bits_equal(outs[alg], s10_sum(torch, count, dev).expand(
                S10_RANKS, count).contiguous()),
                f"slice 10: {alg} at {nbytes} B differs from the closed "
                "form")
        first = outs[S10_ALGS[0]]
        check(all(bits_equal(o, first) for o in outs.values()),
              f"slice 10: the schedules differ at {nbytes} B")


def s10_timings(w, torch, dev, pidx):
    """Ping-pong GB/s 0 <-> 5, staging GB/s each way, peak memory and the
    card's memory in use. Slice 11 times the allreduce per size,
    interpreted (slice 10's path) and replayed in turns, and profiles
    the replayed 256 MiB call: a worker opens one profiler window only
    (a second one in the same process recorded no device time on the
    card)."""
    t = {}
    t["pingpong"] = {}
    for nbytes in S10_PINGPONG:
        x = torch.ones(nbytes // 4, device=dev)
        best = None
        for _ in range(3):
            w.barrier()
            if pidx == 0:
                t0 = time.perf_counter()
                w.send(x, dest=5, tag=11, rank=0)
                w.recv(source=5, tag=12, rank=0)
                dt = time.perf_counter() - t0
                best = dt if best is None else min(best, dt)
            else:
                v, _ = w.recv(source=0, tag=11, rank=5)
                w.send(v, dest=0, tag=12, rank=5)
        if pidx == 0:
            t["pingpong"][nbytes] = {"rtt_ms": best * 1e3,
                                     "GBps": 2 * nbytes / best / 1e9}
        del x
    x = torch.ones(P2P_BYTES // 4, device=dev)
    h = x.cpu()
    torch.cuda.synchronize()
    d2h, h2d = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        h = x.to("cpu")
        d2h.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        x = h.to(dev)
        torch.cuda.synchronize()
        h2d.append(time.perf_counter() - t0)
    t["staging_GBps"] = {
        "device_to_host": P2P_BYTES / statistics.median(d2h) / 1e9,
        "host_to_device": P2P_BYTES / statistics.median(h2d) / 1e9}
    del x, h
    w.barrier()
    res = subprocess.run(["nvidia-smi", "--query-gpu=memory.used,"
                          "memory.total", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    t["card_memory_used"] = res.stdout.strip()
    w.barrier()
    t["peak_device_memory_GiB"] = torch.cuda.max_memory_allocated() / 2**30
    return t


#: slice 11: the frozen wire plans of every plannable family at these
#: per-rank sizes, each fired once (record) and then replayed
S11_FAMILIES = ("allreduce", "bcast", "allgather", "reduce", "gather",
                "scatter", "reduce_scatter_block", "reduce_scatter",
                "alltoall", "scan", "exscan")
S11_SIZES = (8, MIB, 64 * MIB, 256 * MIB)
#: the bf16 SUM allreduce's per-rank sizes (integer-valued, so exact)
S11_BF16_SIZES = (4 * MIB, 256 * MIB)
#: replays per signature (5 until slice 12 joined the script: 3 keep the
#: whole script under 700 s)
S11_REPLAYS = 3
#: replays of a 256 MiB signature other than allreduce: the scans move
#: 1 GiB between the workers per call (8-9 s each on an H100)
S11_REPLAYS_LARGE = 1
#: the cases bench.py's native_rounds app asserts native, under
#: hier_inter_algorithm=recursive_doubling (bench.py:1437-1445)
S11_NATIVE_CASES = (("allreduce", 4096), ("allreduce", 256 * 1024),
                    ("allreduce", MIB), ("bcast", 4096),
                    ("bcast", 256 * 1024), ("allgather", 64 * 1024))
S11_HOST_FIRES = 200  # 8 B fires per host-time window


def s11_signatures():
    """(family, bytes per rank, dtype name or None for f32) of every
    signature slice 11 records and replays."""
    sigs = [(fam, size, None) for fam in S11_FAMILIES for size in S11_SIZES]
    return sigs + [("allreduce", size, "bfloat16")
                   for size in S11_BF16_SIZES]


def s11_replays(fam, size):
    return S11_REPLAYS if fam == "allreduce" or size < 256 * MIB \
        else S11_REPLAYS_LARGE


def s11_args(torch, ops, fam, size, off, dev, dtype=None):
    """The blocking call's arguments for ``fam`` at ``size`` bytes per
    rank: the reductions, bcast and the scans take ``size`` per rank;
    the chunked families (allgather, gather, scatter, the reduce
    scatters, alltoall) chunks of ``size / 8`` per rank, so no buffer
    is larger than ``size`` per rank on either side. ``dtype`` (a
    torch dtype name) applies to the allreduce only."""
    dt = getattr(torch, dtype) if dtype else None
    item = 2 if dtype else 4
    c = max(1, size // item)
    k = max(1, size // 32)

    def rows(n):
        return s10_rows(torch, n, off, dev, dt)

    if fam == "alltoall":
        n8 = S10_N * k
        return (torch.stack([torch.arange(n8, device=dev, dtype=torch.int32)
                             + (off + i) * n8 for i in range(S10_RANKS)]),)
    return {
        "allreduce": (rows(c), ops.SUM),
        "bcast": (rows(c), 5),
        "allgather": (rows(k),),
        "reduce": (rows(c), ops.SUM, 6),
        "gather": (rows(k), 2),
        "scatter": (rows(S10_N * k), 6),
        "reduce_scatter_block": (rows(S10_N * k), ops.SUM),
        "reduce_scatter": (rows(S10_N * k), [k] * S10_N, ops.SUM),
        "scan": (rows(c), ops.SUM),
        "exscan": (rows(c), ops.SUM),
    }[fam]


def s11_want(torch, fam, size, off, dev, dtype=None):
    """The closed form of ``fam`` on ``s11_args``' inputs (integer-valued,
    at most 124 in bf16: exact under any fold order)."""
    c = max(1, size // (2 if dtype else 4))
    k = max(1, size // 32)
    L, N = S10_RANKS, S10_N
    ar = torch.arange(max(c, N * k), device=dev)
    if fam == "allreduce":
        want = s10_sum(torch, c, dev).expand(L, c).contiguous()
        return want.to(getattr(torch, dtype)) if dtype else want
    if fam == "bcast":
        return s10_pattern(torch, c, 5, dev).expand(L, c).contiguous()
    if fam == "allgather":
        return torch.cat([s10_pattern(torch, k, r, dev) for r in range(N)]
                         ).expand(L, N * k).contiguous()
    if fam in ("reduce", "gather"):
        root, n = (6, c) if fam == "reduce" else (2, N * k)
        want = torch.zeros(L, n, device=dev)
        if off <= root < off + L:
            want[root - off] = s10_sum(torch, c, dev) if fam == "reduce" \
                else torch.cat([s10_pattern(torch, k, r, dev)
                                for r in range(N)])
        return want
    if fam == "scatter":
        src = s10_pattern(torch, N * k, 6, dev)
        return torch.stack([src[(off + b) * k:(off + b + 1) * k]
                            for b in range(L)])
    if fam == "reduce_scatter_block":
        return s10_sum(torch, N * k, dev).view(N, k)[off:off + L].contiguous()
    if fam == "reduce_scatter":
        full = s10_sum(torch, N * k, dev)
        return [full[(off + b) * k:(off + b + 1) * k].contiguous()
                for b in range(L)]
    if fam == "alltoall":
        n8 = N * k
        src = torch.arange(n8, device=dev, dtype=torch.int32)
        return torch.stack([torch.cat([
            src[(off + b) * k:(off + b + 1) * k] + j * n8 for j in range(N)])
            for b in range(L)])
    m = (ar[:c] % 13).float()
    r = torch.arange(off, off + L, device=dev).float().unsqueeze(1)
    if fam == "scan":
        return (m * (r + 1) + r * (r + 1) / 2).contiguous()
    return (m * r + r * (r - 1) / 2).contiguous()  # exscan


def s11_equal(got, want):
    if isinstance(want, list):
        return len(got) == len(want) and all(
            bits_equal(g, w) for g, w in zip(got, want))
    return bits_equal(got, want)


def s11_state(cplan, w, fam, args):
    """The spanning plan state of ``fam`` with ``args``' first shape."""
    desc = ("arr", tuple(args[0].shape), str(args[0].dtype))
    sts = [s for k, s in cplan._span_states.items()
           if k[0] == w.cid and k[1][0] == fam and k[1][1] == desc]
    check(len(sts) == 1, f"slice 11: {len(sts)} plan states for {fam} "
                         f"{desc}")
    return sts[0]


def s11_families(w, tmvar, torch, ops, off, dev):
    """Every signature of ``s11_signatures``: the interpreted twin (the
    c_coll entry called directly, what coll_compiled=0 runs), one
    recording fire, then its replays (``s11_replays``); each bitwise the
    closed form (so bitwise each other); then each signature's call
    with ``--mca op ^cuda``, bitwise the closed form. A plan left on
    PlannedXchg must say why; the 256 MiB allreduces, whose 128 MiB
    messages exceed the shm ring, must replay planned for that reason.
    Returns which executor fired each signature's replays and why."""
    from ompi_release_tpu_torch.coll import plan as cplan

    h0 = hits()
    rows = []
    replays = 0
    for fam, size, dtype in s11_signatures():
        args = s11_args(torch, ops, fam, size, off, dev, dtype)
        want = s11_want(torch, fam, size, off, dev, dtype)
        what = f"slice 11: {fam} {dtype or 'float32'} at {size} B"
        check(s11_equal(w.c_coll[fam](w, *args), want),
              f"{what}: the interpreted call differs from the closed "
              "form")
        method = getattr(w, fam)
        t0 = time.perf_counter()
        check(s11_equal(method(*args), want),
              f"{what}: the recording fire differs")
        t1 = time.perf_counter()
        st = s11_state(cplan, w, fam, args)
        check(st.plan is not None, f"{what}: no frozen plan")
        n = s11_replays(fam, size)
        for i in range(n):
            check(s11_equal(method(*args), want),
                  f"{what}: replay {i} differs")
            check(st.last == "native" or (st.last == "planned" and st.why),
                  f"{what}: replay {i} ran {st.last} ({st.why})")
        if fam == "allreduce" and size == 256 * MIB:
            check(st.last == "planned" and "exceeds" in str(st.why)
                  and "shm ring" in str(st.why),
                  f"{what}: replays ran {st.last} ({st.why}), not planned "
                  "for a message larger than the shm ring")
        replays += n
        rows.append({"family": fam, "bytes": size,
                     "dtype": dtype or "float32", "replays": n,
                     "executor": st.last, "why": st.why,
                     "rounds": len(st.plan.rounds),
                     "record_s": t1 - t0,
                     "replay_s": (time.perf_counter() - t1) / n})
        del args, want
    n, s = hits()
    check(s - h0[1] >= replays,
          f"slice 11: coll_compiled_cache_hits rose by {s - h0[1]} over "
          f"{replays} replays")
    spanning = cplan.cache_stats()["spanning_plans"]
    check(spanning > 0, "slice 11: cache_stats reports no spanning plan")
    tmvar.set_value("op", "^cuda")
    try:
        for fam, size, dtype in s11_signatures():
            args = s11_args(torch, ops, fam, size, off, dev, dtype)
            check(s11_equal(w.c_coll[fam](w, *args),
                            s11_want(torch, fam, size, off, dev, dtype)),
                  f"slice 11: {fam} {dtype or 'float32'} at {size} B with "
                  "op ^cuda differs from the closed form")
            del args
    finally:
        tmvar.VARS.unset("op")
    torch.cuda.empty_cache()
    return {"signatures": rows, "spanning_plans": spanning,
            "compiled_hits": s - h0[1]}


def s11_native_rounds(w, tmvar, tpvar, torch, off, dev):
    """bench.py's native_rounds cases under recursive doubling: the
    interpreted leg, the PlannedXchg leg (coll_plan_native=0) and the
    native leg bitwise equal, and the native leg fired by the C
    executor on every replay with no fallback."""
    def pv(name):
        p = tpvar.PVARS.lookup(name)
        return float(p.read()) if p is not None else 0.0

    rows = []
    tmvar.set_value("hier_inter_algorithm", "recursive_doubling")
    try:
        for fam, nbytes in S11_NATIVE_CASES:
            elems = max(1, nbytes // 4)
            x = torch.stack([torch.arange(elems, device=dev).float() * 0.25
                             + i for i in range(S10_RANKS)])

            def call(fam=fam, x=x):
                if fam == "allreduce":
                    return w.allreduce(x)
                if fam == "bcast":
                    return w.bcast(x, root=0)
                return w.allgather(x)

            def leg():
                call()  # record (+ the native compile)
                return [call() for _ in range(S11_REPLAYS)]

            tmvar.set_value("coll_compiled", 0)
            want = leg()[-1]
            tmvar.VARS.unset("coll_compiled")
            tmvar.set_value("coll_plan_native", 0)
            planned = leg()
            tmvar.VARS.unset("coll_plan_native")
            f0, fb0 = pv("plan_native_fires"), pv("plan_native_fallbacks")
            native = leg()
            fires = pv("plan_native_fires") - f0
            fallbacks = pv("plan_native_fallbacks") - fb0
            what = f"slice 11: native_rounds {fam} at {nbytes} B"
            check(all(bits_equal(g, want) for g in planned + native),
                  f"{what}: the legs differ bitwise")
            check(fires >= S11_REPLAYS and fallbacks == 0,
                  f"{what}: {fires} native fires, {fallbacks} fallbacks")
            rows.append({"family": fam, "bytes": nbytes,
                         "native_fires": fires, "fallbacks": fallbacks})
    finally:
        tmvar.VARS.unset("hier_inter_algorithm")
    return rows


def s11_launches(w, torch, cuda_op, off, dev):
    """stream_axpy[sum] launches in one replayed 256 MiB spanning
    allreduce against the interpreted call's."""
    from ompi_release_tpu_torch import ops

    x = s10_rows(torch, P2P_BYTES // 4, off, dev)
    w.allreduce(x)  # the signature's plan exists: this is a replay
    counts = {}
    for leg in ("interpreted", "replayed"):
        torch.cuda.synchronize()
        n0 = cuda_op.LAUNCHES["sum"]
        if leg == "interpreted":
            w.c_coll["allreduce"](w, x, ops.SUM)
        else:
            w.allreduce(x)
        torch.cuda.synchronize()
        counts[leg] = cuda_op.LAUNCHES["sum"] - n0
    check(counts["replayed"] == counts["interpreted"] > 0,
          f"slice 11: stream_axpy[sum] launches in a 256 MiB allreduce: "
          f"{counts}")
    del x
    return counts


def s11_nbc(w, torch, off, dev):
    """iallreduce and ibcast on the spanning world give the blocking
    call's bits; an allreduce_init started 3 times follows its buffer's
    current contents."""
    count = MIB // 4
    x = s10_rows(torch, count, off, dev)
    r1, r2 = w.iallreduce(x), w.ibcast(x, root=5)
    r1.wait()
    r2.wait()
    check(bits_equal(r1.value, w.allreduce(x))
          and bits_equal(r2.value, w.bcast(x, root=5)),
          "slice 11: iallreduce/ibcast differ from the blocking calls")
    buf = x.clone()
    req = w.allreduce_init(buf)
    for k in range(3):
        buf.copy_(x * (k + 1))
        req.start()
        req.wait()
        check(bits_equal(req.value, s10_sum(torch, count, dev).expand(
            S10_RANKS, count) * (k + 1)),
            f"slice 11: allreduce_init start {k} did not follow its buffer")
    return {"iallreduce": True, "ibcast": True, "persistent_starts": 3}


def s11_timings(w, tpvar, torch, off, dev):
    """Spanning allreduce ms and bus GB/s per size, the interpreted call
    (the c_coll entry, slice 10's path) and the replay taken in turns
    (median of 5 each, host clock around a synchronize), with
    hier_inter_bytes per call; host µs per fire at 8 B; one profiled
    256 MiB replay; peak memory."""
    from ompi_release_tpu_torch import ops

    inter = tpvar.PVARS.lookup("hier_inter_bytes")
    t = {"allreduce": {}}
    for nbytes in S10_SIZES:
        x = s10_rows(torch, max(1, nbytes // 4), off, dev)
        legs = {"interpreted": lambda: w.c_coll["allreduce"](w, x, ops.SUM),
                "replayed": lambda: w.allreduce(x)}
        legs["replayed"]()  # the plan is recorded before the turns
        times = {k: [] for k in legs}
        for r in range(5):
            for name in (list(legs) if r % 2 == 0 else list(legs)[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                legs[name]()
                torch.cuda.synchronize()
                times[name].append(time.perf_counter() - t0)
        b0 = inter.read()
        legs["replayed"]()
        row = {"hier_inter_bytes": inter.read() - b0}
        for name, ts in times.items():
            ms = statistics.median(ts) * 1e3
            row[name] = {"ms": ms, "bus_GBps": 2 * (S10_N - 1) / S10_N
                         * nbytes / (ms * 1e-3) / 1e9}
        t["allreduce"][nbytes] = row
        del x, legs
    x = s10_rows(torch, 2, off, dev)
    host = {}
    for name, fn in (("interpreted",
                      lambda: w.c_coll["allreduce"](w, x, ops.SUM)),
                     ("replayed", lambda: w.allreduce(x))):
        fn()
        w.barrier()
        t0 = time.perf_counter()
        for _ in range(S11_HOST_FIRES):
            fn()
        host[name] = (time.perf_counter() - t0) / S11_HOST_FIRES * 1e6
    t["host_us_per_fire_8B"] = host
    x = s10_rows(torch, P2P_BYTES // 4, off, dev)
    w.allreduce(x)
    w.barrier()
    prof = tbench.profile_window(lambda: w.allreduce(x), 1)
    t["profile_replayed_allreduce_256MiB"] = {
        **{k: prof[k] for k in ("window_ms", "device_busy_ms",
                                "busy_share", "launches", "top")},
        "host_gap_ms": prof["window_ms"] - prof["device_busy_ms"]}
    res = subprocess.run(["nvidia-smi", "--query-gpu=memory.used,"
                          "memory.total", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    t["card_memory_used"] = res.stdout.strip()
    del x
    w.barrier()
    t["peak_device_memory_GiB"] = torch.cuda.max_memory_allocated() / 2**30
    return t


def s11_phase(w, rt, tmvar, tpvar, torch, cuda_op, off, dev, pidx):
    """Slice 11 in one worker: the native datapath carries every
    cross-process payload (nativewire selected for the co-hosted peer,
    its byte counter moving, no forced copy, no shm segment), the wire
    plans of every plannable family, the C executor's cases, the
    256 MiB launch count, the nonblocking and persistent calls, then the
    timings."""
    from ompi_release_tpu_torch import ops

    def pv(name):
        p = tpvar.PVARS.lookup(name)
        return float(p.read()) if p is not None else 0.0

    router = rt.wire
    peer = 1 - pidx
    check(router._nw is not None and router._btl_for(peer) is router._nw,
          f"slice 11: the co-hosted peer rides "
          f"{type(router._btl_for(peer)).__name__}, not nativewire")
    nb0 = pv("wire_native_bytes")
    secs = {}
    t0 = time.perf_counter()
    out = {"families": s11_families(w, tmvar, torch, ops, off, dev)}
    secs["families"] = time.perf_counter() - t0
    out["native_rounds"] = s11_native_rounds(w, tmvar, tpvar, torch, off,
                                             dev)
    out["sum_launches_256MiB"] = s11_launches(w, torch, cuda_op, off, dev)
    out["nbc"] = s11_nbc(w, torch, off, dev)
    secs["native_rounds_launches_nbc"] = time.perf_counter() - t0 \
        - secs["families"]
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out["timings"] = s11_timings(w, tpvar, torch, off, dev)
    secs["timings"] = time.perf_counter() - t1
    out["phase_seconds"] = secs
    out["wire_native_bytes"] = pv("wire_native_bytes") - nb0
    out["wire_native_fallback_copies"] = pv("wire_native_fallback_copies")
    out["wire_native_reaped_bytes"] = pv("wire_native_reaped_bytes")
    out["btl_shm_bytes"] = pv("btl_shm_bytes")
    check(out["wire_native_bytes"] > 0,
          "slice 11: wire_native_bytes did not advance")
    check(out["wire_native_fallback_copies"] == 0,
          f"slice 11: {out['wire_native_fallback_copies']} forced copies "
          "on the native datapath")
    check(out["btl_shm_bytes"] == 0,
          f"slice 11: {out['btl_shm_bytes']} bytes went through shm "
          "segments")
    return out


#: slice 12: the rest of the multi-process plane in a job of its own
#: (2 workers x 4 virtual ranks of cuda:0)
S12_PS_ELEMS = 64 * MIB // 4  # a parameter-server window's rank slice
S12_PS_EPOCHS = 5  # fence epochs: 1 interpreted, 1 capture, 3 replays
S12_KV_ELEMS = 16 * MIB // 2  # the bf16 cache window's rank slice
S12_KV_PUTS = 32  # indexed puts per PSCW epoch
S12_KV_EPOCHS = 4
S12_LOCK_INCS = 20  # exclusive-lock increments per thread
S12_AMO_CALLS = 256
S12_SHMEM_ELEMS = 16 * MIB // 4  # the symmetric heap's block per PE
S12_SUM_ELEMS = 64 * MIB // 4  # sum_to_all's block per PE
S12_IO_ELEMS = 256 * MIB // 4 // S10_N  # a rank's block of a 256 MiB file
S12_PP_MICRO = 8
S12_PP_ROWS = 8 * 2048
S12_PP_WIDTH = 512
S12_TIMING_REPS = 2
#: the dropless MoE over ranks 2-5: 2 in each worker
S12_MOE_RANKS = (2, 3, 4, 5)
S12_SPAWN_TAG = 101  # spawn message tags start at USER_TAG_BASE (100)


def s12_pattern(torch, elems, k, dev):
    """An integer-valued f32 payload (exact under every SUM)."""
    return (torch.arange(elems, device=dev, dtype=torch.float32) % 251
            + float(k))


def s12_param_server(w, torch, dev, pidx):
    """8 x 64 MiB f32 window; each fence epoch accumulates 64 MiB into
    each of the other worker's 4 slices (one batch of 4 accumulates and
    a get per home): the home's plans must be CUDA graphs, the second
    and later batches rendered from their frozen template, the window
    and every get equal to the closed form."""
    from ompi_release_tpu_torch.osc import plan as oplan
    from ompi_release_tpu_torch.osc import win_allocate

    other = [r for r in range(S10_N) if r // S10_RANKS != pidx]
    win = win_allocate(w, (S12_PS_ELEMS,))
    f0 = oplan.cache_stats()["batch_templates"]
    gets = []
    for k in range(S12_PS_EPOCHS):
        win.fence()
        pay = s12_pattern(torch, S12_PS_ELEMS, k + pidx, dev)
        for t in other:
            win.accumulate(pay, t)
        gets.append(win.get(other[0]))
        win.fence()
    win.fence_end()
    # each of my slices received every epoch's payload of the other
    # worker, whose pattern is shifted by its process index
    peer = 1 - pidx
    base = s12_pattern(torch, S12_PS_ELEMS, 0, dev)
    want = base * S12_PS_EPOCHS + float(sum(k + peer for k in
                                            range(S12_PS_EPOCHS)))
    data = win.read()
    check(all(bits_equal(data[i], want) for i in range(S10_RANKS)),
          "slice 12: parameter-server slices != the closed form")
    for k, g in enumerate(gets):
        acc = base * (k + 1) + float(sum(j + pidx for j in range(k + 1)))
        check(bits_equal(g.value.to(dev), acc),
              f"slice 12: parameter-server get of epoch {k} != the closed "
              "form")
    if dev.type == "cuda":
        osc_plans_are_graphs(win, "slice 12: the home's epoch plans")
    frozen = oplan.cache_stats()["batch_templates"] - f0
    check(len(win._batch_templates) == 1 and frozen == 1,
          f"slice 12: {len(win._batch_templates)} batch templates, "
          f"{frozen} frozen: later batches were not rendered from the "
          "frozen template")
    plans = len(win._access_plans)
    win.free()
    return {"epochs": S12_PS_EPOCHS, "home_plans": plans}


def s12_kv_fill(w, torch, dev, pidx):
    """A bf16 window (16 MiB a rank) filled across the boundary by
    indexed puts in PSCW epochs, each read back by a get: every get and
    the final page equal the puts (the port alone: the JAX package's home
    cannot apply a bf16 batch)."""
    from ompi_release_tpu_torch.comm.group import Group
    from ompi_release_tpu_torch.osc import win_allocate

    pos = [j * (S12_KV_ELEMS // S12_KV_PUTS) + 17
           for j in range(S12_KV_PUTS)]
    mine = Group(list(range(pidx * S10_RANKS, (pidx + 1) * S10_RANKS)))
    theirs = Group([r for r in range(S10_N) if r // S10_RANKS != pidx])
    t_mine = pidx * S10_RANKS + 1  # the peer puts into my rank +1
    t_theirs = (1 - pidx) * S10_RANKS + 1
    win = win_allocate(w, (S12_KV_ELEMS,), torch.bfloat16)
    gens = {p: torch.Generator(device=dev).manual_seed(120 + p)
            for p in (0, 1)}
    for k in range(S12_KV_EPOCHS):
        vals = {p: torch.randn(S12_KV_PUTS, generator=gens[p],
                               device=dev).to(torch.bfloat16)
                for p in (0, 1)}
        win.post(theirs)
        win.start(theirs)
        for j, i in enumerate(pos):
            win.put(vals[pidx][j], target=t_theirs, index=i)
        get = win.get(target=t_theirs)
        win.complete()
        win.wait()
        page = get.value.to(dev)[pos]
        check(bits_equal(page, vals[pidx]),
              f"slice 12: KV epoch {k}: the get != the puts")
    final = win.read()[t_mine - pidx * S10_RANKS][pos]
    check(bits_equal(final, vals[1 - pidx]),
          "slice 12: the KV page != the peer's last puts")
    if dev.type == "cuda":
        osc_plans_are_graphs(win, "slice 12: KV-cache home epochs")
    check(len(win._batch_templates) == 1,
          f"slice 12: KV batches froze {len(win._batch_templates)} "
          "templates")
    win.free()


def s12_lock_contention(w, torch, dev, pidx):
    """2 threads per worker, each on a window of its own (threads of one
    process use separate windows, as in the reference's two-thread
    program), increment a counter homed on the OTHER worker under its
    exclusive lock: get, flush, put. Every increment is remote; the two
    threads of a worker share its wire and the other worker's window
    service, and each home serves its own app thread's remote traffic
    at the same time. No lost update: every counter is exactly the
    increments."""
    import threading

    from ompi_release_tpu_torch.osc import win_allocate

    wins = [win_allocate(w, (1,), torch.int32) for _ in range(2)]
    tgt = (1 - pidx) * S10_RANKS
    errs = []

    def bump(win):
        try:
            for _ in range(S12_LOCK_INCS):
                win.lock(tgt)
                req = win.get(tgt)
                win.flush(tgt)
                cur = int(req.value.reshape(-1)[0])
                win.put(torch.tensor([cur + 1], dtype=torch.int32), tgt)
                win.unlock(tgt)
        except Exception as e:  # surfaced after join
            errs.append(e)

    t0 = time.perf_counter()
    ths = [threading.Thread(target=bump, args=(x,)) for x in wins]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=300)
    check(not errs and not any(th.is_alive() for th in ths),
          f"slice 12: lock contention: {errs}")
    secs = time.perf_counter() - t0
    w.barrier()
    # this worker homes the other worker's counters on its first rank
    totals = [int(x.read()[0, 0]) for x in wins]
    check(totals == [S12_LOCK_INCS] * 2,
          f"slice 12: locked counters {totals}, want {S12_LOCK_INCS} "
          "each (a lost update)")
    w.barrier()
    for x in wins:
        x.free()
    return {"seconds": secs, "increments": 2 * S12_LOCK_INCS}


def s12_amo(w, torch, dev, pidx):
    """256 fetch_and_op(SUM) and 256 compare_and_swap, each flushed, on
    one int32 element of a remote rank: the fetched values and the
    window equal the closed form. Returns µs per remote AMO, and the
    wire window's span timers over the loop in µs per AMO: this
    worker's requests (pack, round trip) and, since the other worker
    runs the same loop at the same time, its home's service of the
    other's (wait for the locks, the epoch close, the drain, the
    reply)."""
    import numpy as np

    from ompi_release_tpu_torch import ops as tops
    from ompi_release_tpu_torch.mca import pvar as tpvar
    from ompi_release_tpu_torch.osc import win_allocate

    spans = ("pack", "request", "home_batch", "home_recv", "home_unpack",
             "home_apply", "home_wait", "home_close", "home_drain",
             "reply")

    def span_totals():
        return {k: tpvar.PVARS.lookup(f"osc_wire_{k}_seconds").read()
                for k in spans}

    win = win_allocate(w, (AMO_ELEMS,), torch.int32)
    tgt_f = (1 - pidx) * S10_RANKS + 2
    tgt_c = (1 - pidx) * S10_RANKS + 3
    win.lock_all()
    fetched, swapped = [], []
    w.barrier()
    before = span_totals()
    t0 = time.perf_counter()
    for _ in range(S12_AMO_CALLS):
        req = win.fetch_and_op(np.int32(3), tgt_f, op=tops.SUM, index=12345)
        win.flush(tgt_f)
        fetched.append(req.value)
    for k in range(S12_AMO_CALLS):
        req = win.compare_and_swap(np.int32(k + 1), np.int32(k), tgt_c,
                                   index=777)
        win.flush(tgt_c)
        swapped.append(req.value)
    us = (time.perf_counter() - t0) / (2 * S12_AMO_CALLS) * 1e6
    w.barrier()  # the other worker's loop, served here, is over too
    after = span_totals()
    per_us = {k: (after[k] - before[k]) / (2 * S12_AMO_CALLS) * 1e6
              for k in spans}
    win.unlock_all()
    k = np.arange(S12_AMO_CALLS, dtype=np.int32)
    check(np.array_equal(torch.stack(fetched).cpu().numpy(), 3 * k),
          "slice 12: remote fetch_and_op values != 3k")
    check(np.array_equal(torch.stack(swapped).cpu().numpy(), k),
          "slice 12: remote compare_and_swap values != k")
    w.barrier()
    data = win.read()
    check(int(data[2, 12345]) == 3 * S12_AMO_CALLS
          and int(data[3, 777]) == S12_AMO_CALLS
          and int(data.sum()) == 4 * S12_AMO_CALLS,
          "slice 12: the AMO window != the closed form")
    win.free()
    return {"us_per_call": us, "spans_us_per_amo": per_us}


def s12_shmem(w, tmvar, cuda_op, torch, dev, pidx):
    """A 16 MiB symmetric heap: put, get and atomic_fetch_add to a PE in
    the other worker; shmem_ptr of that PE raises ERR_RMA_SHARED;
    sum_to_all at 64 MiB a PE (the hier allreduce) equals the closed form
    and the op ^cuda call and launches stream_axpy[sum]."""
    from ompi_release_tpu_torch.oshmem import ShmemCtx
    from ompi_release_tpu_torch.utils.errors import ErrorCode, MPIError

    ctx = ShmemCtx(w)
    sym = ctx.malloc((S12_SHMEM_ELEMS,))
    remote = (1 - pidx) * S10_RANKS + 1
    vals = s12_pattern(torch, S12_SHMEM_ELEMS, 7 + pidx, dev)
    ctx.put(sym, vals, remote)
    ctx.quiet()
    w.barrier()
    got = ctx.get(sym, remote).to(dev)
    check(bits_equal(got, vals), "slice 12: SHMEM get != the put")
    old = ctx.atomic_fetch_add(sym, torch.ones(S12_SHMEM_ELEMS, device=dev),
                               remote).to(dev)
    check(bits_equal(old, vals), "slice 12: SHMEM fetch-add's old value")
    w.barrier()
    mine = sym.local(pidx * S10_RANKS + 1)
    peer_vals = s12_pattern(torch, S12_SHMEM_ELEMS, 7 + (1 - pidx), dev)
    check(bits_equal(mine, peer_vals + 1),
          "slice 12: my PE's block != the peer's put + 1")
    try:
        sym.local(remote)
        raise AssertionError("chip_smoke: slice 12: shmem_ptr of a PE in "
                             "another process did not raise")
    except MPIError as e:
        check(e.code is ErrorCode.ERR_RMA_SHARED,
              f"slice 12: shmem_ptr raised {e.code}")
    off = pidx * S10_RANKS
    x = torch.stack([s12_pattern(torch, S12_SUM_ELEMS, off + i, dev)
                     for i in range(S10_RANKS)])
    want = (s12_pattern(torch, S12_SUM_ELEMS, 0, dev) * S10_N
            + float(sum(range(S10_N))))
    n0 = cuda_op.LAUNCHES["sum"]
    out = ctx.sum_to_all(x)
    launches = cuda_op.LAUNCHES["sum"] - n0
    check(all(bits_equal(out[i], want) for i in range(S10_RANKS)),
          "slice 12: sum_to_all at 64 MiB != the closed form")
    plain = with_op_excluded(tmvar, lambda: ctx.sum_to_all(x))
    check(bits_equal(out, plain), "slice 12: sum_to_all != op ^cuda")
    check(launches > 0, "slice 12: sum_to_all launched no stream_axpy[sum]")
    del x, out, plain
    sym.free()
    ctx.finalize()
    return {"sum_to_all_sum_launches": launches}


def s12_io(w, torch, dev, pidx, tmp):
    """write_at_all of a 256 MiB file whose per-rank blocks interleave
    the two workers (rank r's block at position 2 i + process index),
    then read_at_all: the file's bytes equal the closed form and every
    block reads back; returns write and read GB/s."""
    import os

    import numpy as np

    from ompi_release_tpu_torch.io import File

    path = os.path.join(tmp, "s12_two_phase.bin")
    n = S12_IO_ELEMS
    off = pidx * S10_RANKS
    blocks = [s12_pattern(torch, n, 1000 * (off + i), dev)
              for i in range(S10_RANKS)]
    offsets = [(2 * i + pidx) * n for i in range(S10_RANKS)]
    f = File(w, path)
    f.set_view(etype=np.float32)
    w.barrier()
    t0 = time.perf_counter()
    total = f.write_at_all(offsets, blocks)
    t_write = time.perf_counter() - t0
    check(total == S10_N * n, f"slice 12: write_at_all counted {total}")
    w.barrier()
    t0 = time.perf_counter()
    back = f.read_at_all(offsets, [n] * S10_RANKS)
    t_read = time.perf_counter() - t0
    f.close()
    for i in range(S10_RANKS):
        check(np.array_equal(back[i], blocks[i].cpu().numpy()),
              f"slice 12: read_at_all block {i} != the written block")
    w.barrier()
    if pidx == 0:
        raw = np.fromfile(path, np.float32)
        base = (np.arange(n, dtype=np.float32) % 251)
        for pos in range(S10_N):
            i, p = divmod(pos, 2)
            rank = p * S10_RANKS + i
            check(np.array_equal(raw[pos * n:(pos + 1) * n],
                                 base + np.float32(1000 * rank)),
                  f"slice 12: the file's block {pos} != rank {rank}'s")
    w.barrier()
    nbytes = S10_N * n * 4
    return {"write_GBps": nbytes / t_write / 1e9,
            "read_GBps": nbytes / t_read / 1e9, "file_bytes": nbytes}


def s12_dropless(w, torch, dev, pidx):
    """dropless_moe over ranks 2-5 (2 in each worker) at slice 6's MoE
    shapes and seed-0 router: each acting rank's output bitwise
    expert_fn per token, what s6_dropless's one-process run gives."""
    from ompi_release_tpu_torch.parallel.ep import dropless_moe

    emb, assign = moe_assignments(torch, dev)
    colors = [0 if r in S12_MOE_RANKS else 1 for r in range(S10_N)]
    sub = w.split(colors)[S12_MOE_RANKS[0]]
    check(sub.spans_processes and len(sub.local_comm_ranks) == 2,
          "slice 12: the MoE comm does not span the workers")
    per = emb.shape[0] // len(S12_MOE_RANKS)
    acting = list(sub.local_comm_ranks)
    tokens = [emb[i * per:(i + 1) * per] for i in acting]
    assigns = [assign[i * per:(i + 1) * per] for i in acting]

    def expert_fn(e, x):
        return x * (e + 1) + e

    outs = dropless_moe(sub, tokens, assigns, expert_fn, MOE_EXPERTS)
    for i in range(len(acting)):
        want = torch.empty_like(tokens[i])
        for e in range(MOE_EXPERTS):
            sel = assigns[i] == e
            want[sel] = expert_fn(e, tokens[i][sel])
        check(bits_equal(outs[i].to(dev), want),
              f"slice 12: dropless_moe acting rank {acting[i]} != "
              "expert_fn per token")
    del emb, assign, tokens, outs


def s12_tree(w, tmvar, cuda_op, torch, dev, pidx):
    """The TpuLM's 66 gradients (integer-valued, so every fold order
    gives the same bits) on the spanning world: the planned tree pass,
    blocking and under the progress thread, bitwise the per-leaf
    allreduce; stream_axpy[sum] launches in the planned pass."""
    from ompi_release_tpu_torch.mca import pvar as tpvar
    from ompi_release_tpu_torch.parallel import tree as tree_mod

    off = pidx * S10_RANKS
    grads = {f"g{i:02d}": g[off:off + S10_RANKS].contiguous()
             for i, g in enumerate(grad_list(torch, dev, integer=True))}
    sync = tree_mod.TreeSync(w, mean=False)
    n0 = cuda_op.LAUNCHES["sum"]
    out = sync.issue(grads).wait()
    launches = cuda_op.LAUNCHES["sum"] - n0
    tmvar.set_value("progress_thread", True)
    try:
        hidden0 = tpvar.PVARS.lookup("nbc_hidden_seconds").read()
        out_bg = sync.issue(grads).wait()
        hidden = tpvar.PVARS.lookup("nbc_hidden_seconds").read() - hidden0
    finally:
        tmvar.VARS.unset("progress_thread")
    for k, g in grads.items():
        ref = w.allreduce(g)
        check(bits_equal(out[k].to(dev), ref.to(dev))
              and bits_equal(out_bg[k].to(dev), ref.to(dev)),
              f"slice 12: tree pass {k} != the per-leaf allreduce")
    check(launches > 0, "slice 12: the tree pass launched no "
                        "stream_axpy[sum]")
    nbytes = sum(g[0].numel() * 4 for g in grads.values())
    del grads, out, out_bg
    return {"sum_launches": launches, "leaves": 66,
            "bytes_per_rank": nbytes, "nbc_hidden_s": hidden}


def s12_pipeline(w, torch, dev, pidx):
    """HostPipeline with one stage per rank, 8 microbatches of
    (8 x 2048, 512) f32 through x @ (0.5 I), at the default
    ``pml_eager_limit``: each worker runs its 4 local stages in stage
    order (one controller plays its ranks; a 32 MiB boundary to a stage
    of the same worker is handed over by a standard send), and the
    boundary between the workers rides the wire. The legs run in turns
    (nonblocking, blocking, blocking, nonblocking: the first pass pays
    the first calls' costs); every pass bitwise the closed form
    x * 0.5^8, so the nonblocking leg is bitwise the blocking leg.
    Returns each leg's seconds per pass."""
    from ompi_release_tpu_torch.parallel import pp as pp_mod

    W = torch.eye(S12_PP_WIDTH, device=dev) * 0.5
    mbs = [torch.full((S12_PP_ROWS, S12_PP_WIDTH), float(k + 1), device=dev)
           for k in range(S12_PP_MICRO)]
    legs = {"nonblocking": [], "blocking": []}
    for leg in ("nonblocking", "blocking", "blocking", "nonblocking"):
        w.barrier()
        t0 = time.perf_counter()
        outs = None
        for s in w.local_comm_ranks:
            outs = pp_mod.HostPipeline(
                w, lambda x: torch.as_tensor(x, device=dev) @ W,
                stage=s, nonblocking=leg == "nonblocking").run(mbs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        legs[leg].append(time.perf_counter() - t0)
        if pidx == 1:
            check(len(outs) == S12_PP_MICRO,
                  f"slice 12: HostPipeline ({leg}) outputs")
            for k, a in enumerate(outs):
                want = torch.full_like(mbs[k], float(k + 1) * 0.5 ** S10_N)
                check(bits_equal(a, want),
                      f"slice 12: HostPipeline ({leg}) microbatch {k} != "
                      "the closed form")
    w.barrier()
    return legs


def s12_dpm(w, torch, dev, pidx):
    """publish_name/lookup_name, comm_accept/comm_connect between the two
    workers' local comms (the rendezvous crosses the processes), a send
    over the intercommunicator and an allreduce over its merge; a lookup
    of a closed port raises ERR_PROC_FAILED in both workers."""
    from ompi_release_tpu_torch.comm import dpm
    from ompi_release_tpu_torch.utils.errors import ErrorCode, MPIError

    subs = w.split([0] * S10_RANKS + [1] * S10_RANKS)
    mine = subs[pidx * S10_RANKS]
    if pidx == 0:
        port = dpm.open_port()
        dpm.publish_name("s12-svc", port)
        dead = dpm.open_port()
        dpm.publish_name("s12-dead", dead)
        dpm.close_port(dead)
    w.barrier()
    port = dpm.lookup_name("s12-svc", timeout_s=60)
    inter = (dpm.comm_accept(mine, port, timeout_s=120) if pidx == 0
             else dpm.comm_connect(mine, port, timeout_s=120))
    check(inter.remote_size == S10_RANKS, "slice 12: intercomm size")
    x = torch.arange(S10_RANKS * 4, dtype=torch.int32, device=dev)
    if pidx == 0:
        inter.send(x, dest=2, tag=3, rank=1)
        v, st = inter.recv(source=2, tag=4, rank=1)
        check(bits_equal(v.to(dev), x * 2) and st.source == 2,
              "slice 12: the intercomm's reply")
    else:
        v, st = inter.recv(source=1, tag=3, rank=2)
        check(bits_equal(v.to(dev), x) and st.source == 1,
              "slice 12: the intercomm's send")
        inter.send(v * 2, dest=1, tag=4, rank=2)
    merged = inter.merge(high=(pidx == 1))
    off = pidx * S10_RANKS
    rows = torch.stack([torch.full((1024,), float(off + i), device=dev)
                        for i in range(S10_RANKS)])
    got = merged.allreduce(rows)
    check(bits_equal(got, torch.full_like(rows, float(sum(range(S10_N))))),
          "slice 12: allreduce over intercomm_merge != the closed form")
    failed = {}
    for name in ("s12-dead",):
        try:
            dpm.lookup_name(name, timeout_s=10)
            failed[name] = None
        except MPIError as e:
            failed[name] = e.code
    w.barrier()
    if pidx == 0:
        dpm.close_port(port)
    w.barrier()
    try:
        dpm.lookup_name("s12-svc", timeout_s=10)
        failed["s12-svc"] = None
    except MPIError as e:
        failed["s12-svc"] = e.code
    check(all(c is ErrorCode.ERR_PROC_FAILED for c in failed.values()),
          f"slice 12: lookups of closed ports gave {failed}")
    w.barrier()


def s12_spawn(w, pidx):
    """comm_spawn of one child (this script with ``--slice12-child``)
    from worker 0: bytes there and back over the child's lifeline; the
    child must exit 0."""
    import os

    from ompi_release_tpu_torch.comm import comm_spawn

    if pidx == 0:
        t0 = time.perf_counter()
        job = comm_spawn([sys.executable, os.path.abspath(__file__),
                          "--slice12-child"], 1, timeout_s=300)
        job.wait_running(timeout_s=240)
        payload = bytes(range(256)) * 64
        job.send(0, S12_SPAWN_TAG, payload)
        rank, back = job.recv(S12_SPAWN_TAG + 1, timeout_ms=120_000)
        check(rank == 0 and back == payload[::-1],
              "slice 12: the spawned child's reply")
        rc = job.wait(timeout_s=240)
        check(rc == 0, f"slice 12: the spawned child exited {rc}")
        check(all(p.poll() is not None for p in job.job.procs.values()),
              "slice 12: the spawned child outlived its job")
        secs = time.perf_counter() - t0
    else:
        secs = None
    w.barrier()
    return secs


def s12_child():
    """The child ``comm_spawn`` launches: one rank under its parent's
    coordinator, echoing the parent's bytes reversed."""
    import ompi_release_tpu_torch as mpi
    from ompi_release_tpu_torch.runtime.runtime import Runtime

    mpi.init()
    rt = Runtime.current()
    _src, _tag, payload = rt.agent.ep.recv(tag=S12_SPAWN_TAG,
                                           timeout_ms=120_000)
    rt.agent.ep.send(0, S12_SPAWN_TAG + 1, bytes(payload)[::-1])
    mpi.finalize()
    return 0


def s12_timings(w, tmvar, torch, dev, pidx):
    """ms per 64 MiB remote-accumulate fence epoch, interpreted
    (``osc_compiled`` false: the batch packed per call, the home's close
    interpreted) and replayed (the frozen template, the home's graph), in
    turns; µs per remote AMO comes from ``s12_amo``."""
    from ompi_release_tpu_torch.osc import win_allocate

    win = win_allocate(w, (S12_PS_ELEMS,))
    tgt = (1 - pidx) * S10_RANKS
    pay = s12_pattern(torch, S12_PS_ELEMS, pidx, dev)

    def epoch():
        win.fence()
        win.accumulate(pay, tgt)
        win.fence()

    def leg(compiled):
        if not compiled:
            tmvar.set_value("osc_compiled", False)
        try:
            # a cvar write re-plans: the first close freezes, the second
            # captures (replayed leg); two warm-up epochs either way
            epoch()
            epoch()
            samples = []
            for _ in range(S12_TIMING_REPS):
                w.barrier()
                t0 = time.perf_counter()
                epoch()
                samples.append((time.perf_counter() - t0) * 1e3)
            return samples
        finally:
            if not compiled:
                tmvar.VARS.unset("osc_compiled")

    win.fence()
    epoch()
    out = {"replayed": [], "interpreted": []}
    for r in range(2):
        order = ("replayed", "interpreted") if r == 0 else \
            ("interpreted", "replayed")
        for name in order:
            out[name] += leg(name == "replayed")
    win.fence_end()
    win.free()
    return {name: {"median_ms": statistics.median(v), "samples_ms": v}
            for name, v in out.items()}


def s12_phase(w, rt, tmvar, torch, cuda_op, dev, pidx):
    """Slice 12 in one worker: every step, then its timings."""
    import tempfile

    secs = {}
    out = {}

    def step(name, fn):
        t0 = time.perf_counter()
        out[name] = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        secs[name] = time.perf_counter() - t0

    step("param_server", lambda: s12_param_server(w, torch, dev, pidx))
    step("kv_fill", lambda: s12_kv_fill(w, torch, dev, pidx))
    step("lock_contention", lambda: s12_lock_contention(w, torch, dev, pidx))
    step("amo", lambda: s12_amo(w, torch, dev, pidx))
    step("shmem", lambda: s12_shmem(w, tmvar, cuda_op, torch, dev, pidx))
    with tempfile.TemporaryDirectory() as td:
        # one directory both workers see: worker 0's, broadcast by name
        name = td if pidx == 0 else None
        shared = s12_shared_dir(w, name, pidx)
        step("io", lambda: s12_io(w, torch, dev, pidx, shared))
        w.barrier()
    step("dropless_moe", lambda: s12_dropless(w, torch, dev, pidx))
    step("tree", lambda: s12_tree(w, tmvar, cuda_op, torch, dev, pidx))
    step("host_pipeline_s", lambda: s12_pipeline(w, torch, dev, pidx))
    step("dpm", lambda: s12_dpm(w, torch, dev, pidx))
    step("spawn_s", lambda: s12_spawn(w, pidx))
    t0 = time.perf_counter()
    out["epoch_64MiB_ms"] = s12_timings(w, tmvar, torch, dev, pidx)
    secs["timings"] = time.perf_counter() - t0
    out["phase_seconds"] = secs
    return out


def s12_shared_dir(w, name, pidx):
    """Worker 0's directory name, sent to worker 1 (both workers run on
    one host in this job)."""
    import numpy as np

    buf = np.zeros(256, np.uint8)
    if pidx == 0:
        raw = name.encode()
        buf[:len(raw)] = np.frombuffer(raw, np.uint8)
        w.send(buf, dest=S10_RANKS, tag=31, rank=0)
        return name
    got, _ = w.recv(source=0, tag=31, rank=S10_RANKS)
    arr = np.asarray(got.cpu()).astype(np.uint8)
    return bytes(arr[arr != 0]).decode()


def s10_worker():
    """One worker of the slice-10 job (``chip_smoke.py --slice10-worker``
    under ``tools.tpurun``): writes its results as JSON to
    ``$CHIP_SMOKE_S10_OUT/worker<process index>.json``. Any failure
    raises: the worker exits non-zero and the launcher fails the job."""
    import os

    import torch

    mode = os.environ["CHIP_SMOKE_S10_MODE"]  # main | s11 | dcn | s12
    if mode == "dcn":
        # a distinct shm identity per worker: every payload rides the
        # DCN staging path (chunked frames over the OOB)
        os.environ["OMPITPU_HOST_ID"] = \
            "s10-dcn-" + os.environ["OMPITPU_NODE_ID"]
    import ompi_release_tpu_torch as mpi
    from ompi_release_tpu_torch.examples import ring_tpu
    from ompi_release_tpu_torch.mca import pvar as tpvar
    from ompi_release_tpu_torch.mca import var as tmvar
    from ompi_release_tpu_torch.ops import cuda_op
    from ompi_release_tpu_torch.runtime.runtime import Runtime

    t_start = time.perf_counter()
    w = mpi.init(cli_args=["--mca", "runtime_virtual_ranks",
                           str(S10_RANKS)])
    rt = Runtime.current()
    pidx = int(rt.bootstrap["process_index"])
    off = rt.local_rank_offset
    dev = w.device
    check(w.size == S10_N and w.spans_processes and dev.type == "cuda",
          f"slice 10: WORLD {w.size} ranks on {dev}, spans "
          f"{w.spans_processes}")
    check(w._coll_providers["allreduce"] == ["hier"],
          f"slice 10: allreduce providers {w._coll_providers}")
    out = {"pidx": pidx, "pid": os.getpid(), "mode": mode}
    if mode == "dcn":
        # slice 10's DCN leg, now the vectored-socket leg of the native
        # datapath: a 64 MiB allreduce fired twice (record, replay) and
        # a 64 MiB send
        nw = rt.wire._nw
        check(nw is not None and rt.wire._btl_for(1 - pidx) is nw
              and not nw._same_host(1 - pidx),
              "slice 11 (dcn): the peer does not ride nativewire's "
              "socket leg")
        zc = tpvar.PVARS.lookup("wire_bytes_zero_copy")
        nb = tpvar.PVARS.lookup("wire_native_bytes")
        z0, n0 = zc.read(), nb.read()
        count = S10_DCN_BYTES // 4
        for _ in range(2):
            got = w.allreduce(s10_rows(torch, count, off, dev))
            check(bits_equal(got, s10_sum(torch, count, dev).expand(
                S10_RANKS, count).contiguous()),
                "slice 10 (dcn): the 64 MiB allreduce differs")
        if pidx == 0:
            w.send(s10_pattern(torch, count, 3, dev), dest=6, tag=5, rank=1)
        else:
            v, st = w.recv(source=1, tag=5, rank=6)
            check(bits_equal(v, s10_pattern(torch, count, 3, dev)),
                  "slice 10 (dcn): the 64 MiB send differs")
        w.barrier()
        out["wire_bytes_zero_copy"] = zc.read() - z0
        out["wire_native_bytes"] = nb.read() - n0
        copies = tpvar.PVARS.lookup("wire_native_fallback_copies").read()
        out["wire_native_fallback_copies"] = copies
        check(out["wire_bytes_zero_copy"] > 0,
              "slice 10 (dcn): wire_bytes_zero_copy stayed 0")
        check(out["wire_native_bytes"] > 0 and copies == 0,
              f"slice 11 (dcn): native bytes {out['wire_native_bytes']}, "
              f"forced copies {copies}")
    elif mode == "s11":
        cuda_op.reset_launches()
        out["s11"] = s11_phase(w, rt, tmvar, tpvar, torch, cuda_op, off,
                               dev, pidx)
        out["s11_sum_launches"] = cuda_op.LAUNCHES["sum"]
    elif mode == "s12":
        torch.cuda.reset_peak_memory_stats(dev)
        cuda_op.reset_launches()
        out["s12"] = s12_phase(w, rt, tmvar, torch, cuda_op, dev, pidx)
        torch.cuda.synchronize()
        out["s12_sum_launches"] = cuda_op.LAUNCHES["sum"]
        out["peak_device_memory_GiB"] = \
            torch.cuda.max_memory_allocated(dev) / 2 ** 30
    else:
        cuda_op.reset_launches()
        sums = []
        outs = []
        for item in s10_collectives(w, torch, off, dev):
            outs.append(item)
            sums.append((item[0], cuda_op.LAUNCHES["sum"]))
        # both steps fold on the card: the shadow comm's local fold
        # alone, then the spanning call (local + inter fold)
        x = s10_rows(torch, P2P_BYTES // 4, off, dev)
        n0 = cuda_op.LAUNCHES["sum"]
        w._hier_module.shadow.allreduce(x)
        local = cuda_op.LAUNCHES["sum"] - n0
        w.allreduce(x)
        spanning = cuda_op.LAUNCHES["sum"] - n0 - local
        check(0 < local < spanning,
              f"slice 10: SUM launches local {local}, spanning {spanning}: "
              "the inter fold did not launch the kernel")
        out["sum_launches_local_vs_spanning_256MiB"] = [local, spanning]
        del x
        s10_schedules(w, tmvar, torch, off, dev)
        p2p = s10_p2p(w, torch, off, dev, ring_tpu)
        torch.cuda.synchronize()
        out["launches"] = dict(cuda_op.LAUNCHES)
        prev = 0
        per_size = {}
        for name, n in sums:
            per_size[name] = n - prev
            prev = n
        out["sum_launches_by_call"] = per_size
        for nbytes in S10_SIZES:
            if nbytes >= 4 * MIB:
                check(per_size[f"allreduce_{nbytes}"] > 0,
                      f"slice 10: stream_axpy[sum] did not launch in the "
                      f"{nbytes} B allreduce")
        s10_check_collectives(torch, outs, off, dev)
        out["ring"] = p2p["ring"]
        tmvar.set_value("op", "^cuda")
        try:
            plain = list(s10_collectives(w, torch, off, dev))
        finally:
            tmvar.VARS.unset("op")
        for (name, got), (_, want) in zip(outs, plain):
            check(bits_equal(got, want),
                  f"slice 10: {name} differs from the op ^cuda call")
        del outs, plain
        torch.cuda.empty_cache()
        out["timings"] = s10_timings(w, torch, dev, pidx)
        torch.cuda.synchronize()
        out["s10_sum_launches"] = cuda_op.LAUNCHES["sum"]
        cuda_op.reset_launches()
        out["s11"] = s11_phase(w, rt, tmvar, tpvar, torch, cuda_op, off,
                               dev, pidx)
        torch.cuda.synchronize()
        out["s11_sum_launches"] = cuda_op.LAUNCHES["sum"]
    if mode in ("main", "s11"):
        # the local shadow comm's plans are CUDA graphs, as on one
        # process (slice 11's timings fire each size 11 times in one
        # generation); the spanning comm's frozen plans are wire plans,
        # never in-process device plans
        shadow = w._hier_module.shadow
        entries = {k: e for k, e in plan_entries(shadow).items()
                   if k[1][0] == "allreduce"}
        check(len(entries) >= len(S10_SIZES) and all(
            "bad" not in e and e["frozen"].graph is not None
            for e in entries.values()),
            f"slice 10: the shadow comm's allreduce plans are not all "
            f"graphs: {bad_plans(shadow)}")
        check(not plan_entries(w), "slice 10: the spanning comm froze an "
              "in-process plan")
        out["shadow_graphs"] = len(entries)
    out["seconds"] = time.perf_counter() - t_start
    with open(os.path.join(os.environ["CHIP_SMOKE_S10_OUT"],
                           f"worker{pidx}.json"), "w") as f:
        json.dump(out, f)
    mpi.finalize()
    return 0


def run_slice_job(n, mode, procs, out_dir, mca=(), job_kw=None,
                  heartbeat_s=0.5, miss_limit=20, timeout_s=400,
                  every=True):
    """One tpurun job of the port running this script's slice-``n``
    worker phase (``--slice<n>-worker``; ``procs`` workers on cuda:0,
    the mode and ``out_dir`` in ``CHIP_SMOKE_S<n>_MODE`` / ``_OUT``).
    Fails if a worker outlived the job or any process the job started
    left a shm segment, a nativewire ring or an event ring behind, and,
    with ``every``, unless each of the ``procs`` workers wrote one
    ``worker<i>.json``. Returns (rc, wall seconds, the job, the
    workers' results sorted by process index and incarnation)."""
    import glob
    import os

    from ompi_release_tpu_torch.tools.tpurun import Job

    env_keep = dict(os.environ)
    os.environ[f"CHIP_SMOKE_S{n}_MODE"] = mode
    os.environ[f"CHIP_SMOKE_S{n}_OUT"] = out_dir
    t0 = time.perf_counter()
    try:
        job = Job(procs, [sys.executable, os.path.abspath(__file__),
                          f"--slice{n}-worker"], list(mca),
                  heartbeat_s=heartbeat_s, miss_limit=miss_limit,
                  **(job_kw or {}))
        rc = job.run(timeout_s=timeout_s)
    finally:
        os.environ.clear()
        os.environ.update(env_keep)
    wall = time.perf_counter() - t0
    check(all(p.poll() is not None for p in job.procs.values()),
          f"slice {n} ({mode}): a worker outlived its job")
    # shm segments carry their creator's pid; nativewire's rings and
    # event rings the owner's token, which starts with its pid in hex
    # (btl/nativewire _ring_name)
    leftovers = [f for pid in job._local_pids
                 for pat in (f"ompitpu-{pid}-*", f"onw-{pid:x}-*",
                             f"onwev-{pid:x}-*")
                 for f in glob.glob(os.path.join("/dev/shm", pat))]
    check(not leftovers, f"slice {n} ({mode}): shm segments or rings "
                         f"left {leftovers}")
    res = []
    for path in glob.glob(os.path.join(out_dir, "worker*.json")):
        with open(path) as f:
            res.append(json.load(f))
    res.sort(key=lambda r: (r["pidx"], r.get("incarnation", 0)))
    check(not every or [r["pidx"] for r in res] == list(range(procs)),
          f"slice {n} ({mode}): workers {[r['pidx'] for r in res]} of "
          f"{procs} wrote a result (job rc {rc})")
    return rc, wall, job, res


def phase_slice10(cuda_op, torch, mode="main"):
    """Slices 10 and 11's path: the parent builds the kernel library and
    the native library, then runs a tpurun job of 2 workers x 4 virtual
    ranks on cuda:0 (COMM_WORLD spans 8 ranks over 2 processes; ``mode``
    "main" runs slice 10's phase and then slice 11's in each worker,
    "s11" slice 11's alone) and a second, shorter job on the DCN leg.
    The workers share the card with this process, which releases its
    cached memory first. Returns what ``report_slice10`` prints and the
    SUM launches summed over the workers, per slice."""
    import gc
    import tempfile

    from ompi_release_tpu_torch.native import build_library

    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 3: slice 10: this process holds "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB on the card")
    t0 = time.perf_counter()
    cuda_op.build()
    so, built = build_library()
    log(f"phase 3: slice 10: native library {so} (make ran: {built}) and "
        f"the kernels built in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as td:
        rc, wall, _, res = run_slice_job(10, mode, S10_PROCS, td,
                                         timeout_s=600)
    check(rc == 0, f"slice 10: the job exited {rc}")
    s11_sums = [r["s11_sum_launches"] for r in res]
    check(all(n > 0 for n in s11_sums),
          f"slice 11: stream_axpy[sum] launches per worker {s11_sums}")
    sums = [0, 0]
    if mode == "main":
        sums = [r["s10_sum_launches"] for r in res]
        check(all(n > 0 for n in sums),
              f"slice 10: stream_axpy[sum] launches per worker {sums}")
        passes = sum(r["ring"][0] for r in res)
        check(passes == (S10_N - 1) + 3 * S10_N
              and [r["ring"][1] for r in res] == [0, None],
              f"slice 10: ring passes {passes}, {[r['ring'] for r in res]}")
        log(f"phase 3: slice-10 path: COMM_WORLD of {S10_N} ranks over "
            f"{S10_PROCS} processes, every result bitwise its closed form "
            f"and the op ^cuda call; stream_axpy[sum] launches {sums}")
    log(f"phase 3: slice-11 path: nativewire carries every payload, every "
        f"plannable family's replays bitwise the interpreted call, the "
        f"closed form and op ^cuda; native_rounds' cases fired by the C "
        f"executor; stream_axpy[sum] launches {s11_sums}; the job took "
        f"{wall:.1f} s")
    for r in res:
        for row in r["s11"]["families"]["signatures"]:
            log(json.dumps({"s11_plan": row["family"],
                            "bytes": row["bytes"], "dtype": row["dtype"],
                            "replays": row["replays"], "worker": r["pidx"],
                            "executor": row["executor"],
                            "rounds": row["rounds"], "why": row["why"],
                            "record_s": row["record_s"],
                            "replay_s": row["replay_s"]}))
    with tempfile.TemporaryDirectory() as td:
        rc2, wall2, _, res2 = run_slice_job(10, "dcn", S10_PROCS, td,
                                            timeout_s=600)
    check(rc2 == 0, f"slice 10 (dcn): the job exited {rc2}")
    log(f"phase 3: slices 10 and 11 passed in "
        f"{time.perf_counter() - t0:.1f} s")
    return {"res": res, "wall": wall, "res_dcn": res2, "wall_dcn": wall2,
            "sum": sum(sums), "sum_s11": sum(s11_sums), "mode": mode}


def phase_slice12(cuda_op, torch):
    """Slice 12's path: a tpurun job of its own, 2 workers x 4 virtual
    ranks on cuda:0 (the libraries are built by then), every step of
    ``s12_phase`` in each worker; the job must exit 0 and leave no
    worker, shm segment or ring behind (``run_slice_job`` checks). Returns the
    workers' results and the SUM launches summed over them."""
    import gc
    import tempfile

    from ompi_release_tpu_torch.native import build_library

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cuda_op.build()
    build_library()
    with tempfile.TemporaryDirectory() as td:
        rc, wall, _, res = run_slice_job(10, "s12", S10_PROCS, td,
                                         timeout_s=600)
    check(rc == 0, f"slice 12: the job exited {rc}")
    sums = [r["s12_sum_launches"] for r in res]
    check(all(n > 0 for n in sums),
          f"slice 12: stream_axpy[sum] launches per worker {sums}")
    log(f"phase 3: slice-12 path: wire windows (home epochs as CUDA "
        f"graphs, frozen batch templates), a bf16 KV fill, lock "
        f"contention, remote AMOs, SHMEM across processes, two-phase IO, "
        f"the spanning dropless MoE, the tree pass, HostPipeline, dpm and "
        f"comm_spawn, each equal to its closed form; stream_axpy[sum] "
        f"launches {sums}; the job took {wall:.1f} s, the phase "
        f"{time.perf_counter() - t0:.1f} s")
    return {"res": res, "wall": wall, "sum": sum(sums)}


def report_slice12(s12):
    """Slice 12's numbers per worker, each beside the card's name and
    power limit."""
    card = card_line()
    for r in s12["res"]:
        o = r["s12"]
        log(json.dumps({
            "s12_worker": r["pidx"], "card": card,
            "epoch_64MiB_remote_accumulate_ms": o["epoch_64MiB_ms"],
            "remote_amo_us_per_call": o["amo"]["us_per_call"],
            "remote_amo_spans_us": o["amo"]["spans_us_per_amo"],
            "two_phase_write_GBps": o["io"]["write_GBps"],
            "two_phase_read_GBps": o["io"]["read_GBps"],
            "lock_contention": o["lock_contention"],
            "shmem": o["shmem"], "tree": o["tree"],
            "host_pipeline_s": o["host_pipeline_s"],
            "spawn_s": o["spawn_s"],
            "stream_axpy_sum_launches": r["s12_sum_launches"],
            "peak_device_memory_GiB": r["peak_device_memory_GiB"],
            "phase_seconds": o["phase_seconds"],
            "seconds": r["seconds"]}))
    log(json.dumps({"s12_job_wall_s": s12["wall"], "card": card}))


def report_slice10(s10, baseline=None):
    """Slices 10 and 11's timings, each beside the card's name and power
    limit: the spanning allreduce per size interpreted (slice 10's path)
    and replayed (slice 11's) beside, when given, the one-process 8-rank
    tuned allreduce's ms."""
    card = card_line()
    for r in s10["res"]:
        t11 = r["s11"]["timings"]
        for nbytes, row in t11["allreduce"].items():
            one = (baseline or {}).get(int(nbytes))
            log(json.dumps({"s11_allreduce_bytes_per_rank": int(nbytes),
                            "worker": r["pidx"], **row,
                            "one_process_8rank_ms": one, "card": card}))
        s11 = r["s11"]
        log(json.dumps({
            "s11_worker": r["pidx"], "card": card,
            **{k: v for k, v in t11.items() if k != "allreduce"},
            "native_rounds": s11["native_rounds"],
            "sum_launches_256MiB": s11["sum_launches_256MiB"],
            "spanning_plans": s11["families"]["spanning_plans"],
            "compiled_hits": s11["families"]["compiled_hits"],
            "wire_native_bytes": s11["wire_native_bytes"],
            "wire_native_fallback_copies":
                s11["wire_native_fallback_copies"],
            "wire_native_reaped_bytes": s11["wire_native_reaped_bytes"],
            "btl_shm_bytes": s11["btl_shm_bytes"],
            "sum_launches": r["s11_sum_launches"],
            "phase_seconds": s11["phase_seconds"],
            "seconds": r["seconds"]}))
        if "timings" in r:
            log(json.dumps({
                "s10_worker": r["pidx"], "card": card, **r["timings"],
                "sum_launches_by_call": r["sum_launches_by_call"],
                "sum_launches_local_vs_spanning_256MiB":
                    r["sum_launches_local_vs_spanning_256MiB"]}))
    log(json.dumps({"s10_dcn": [
        {k: r[k] for k in ("wire_bytes_zero_copy", "wire_native_bytes",
                           "wire_native_fallback_copies")}
        for r in s10["res_dcn"]], "job_wall_s": s10["wall_dcn"],
        "card": card}))
    log(json.dumps({"s10_job_wall_s": s10["wall"], "card": card}))


# ---------------------------------------------------------------------------
# slice 13: fault tolerance — ULFM detection, revoke/shrink, respawn and
# the C executor's fault word, under ElasticStep training the TpuLM
# ---------------------------------------------------------------------------

S13_PROCS = 3
S13_RANKS = 2  # virtual ranks a worker owns on cuda:0
S13_N = S13_PROCS * S13_RANKS
S13_SEQ = 2048  # tokens per rank per step: (1, 2048)
S13_HEARTBEAT_S = 0.3
S13_MISS_LIMIT = 3
S13_CKPT_EVERY = 2
#: job A: shrink; (steps, the step inside which worker 2 is killed)
S13_A = (8, 5)
#: job B: respawn
S13_B = (6, 3)
S13_LR = 1e-3
#: seconds from the kill to the survivors' typed error (the gate)
S13_DETECT_S = 5.0


def s13_batch(torch, cfg, step, wr, dev):
    """Rank ``wr``'s (1, S13_SEQ) tokens of ``step``, from the seed
    (step, wr), and their next-token targets. The ids are drawn by a
    Zipf law (p(k) ~ 1 / (k + 1)), as words are: uniform ids leave a
    model nothing to learn, and AdamW's first steps then only add noise
    (the loss rose over 8 steps on the card)."""
    g = torch.Generator().manual_seed(step * 4096 + wr)
    zipf = 1.0 / torch.arange(1, cfg.vocab + 1, dtype=torch.float64)
    tok = torch.multinomial(zipf, S13_SEQ, replacement=True,
                            generator=g).view(1, S13_SEQ)
    return tok.to(dev), torch.roll(tok, -1, dims=1).to(dev)


def s13_checksum(torch, params):
    """Two exact integer sums over the parameters' bits (plain and
    position-weighted): equal iff bitwise equal, up to a collision."""
    from ompi_release_tpu_torch.optim import leaves

    s1 = s2 = 0
    for p in leaves(params):
        iv = p.detach().reshape(-1).view(
            torch.int16 if p.element_size() == 2 else torch.int32).long()
        w = torch.arange(iv.numel(), device=iv.device) % 65521 + 1
        s1 += int(iv.sum())
        s2 += int((iv * w).sum())
    return [s1, s2]


def s13_unstack(grads):
    """The 66 per-layer leaves a data-parallel trainer hands over, one
    row per local rank: embed, ln_f and each stacked layer tensor's
    slices (the layer axis follows the rank axis)."""
    out = {"embed": grads["embed"], "ln_f": grads["ln_f"]}
    for name, t in sorted(grads["layers"].items()):
        for layer in range(t.shape[1]):
            out[f"{name}{layer}"] = t[:, layer]
    return out


def s13_adamw(torch, state, grads, lr=S13_LR):
    """optax.adamw's update (betas 0.9/0.999, eps 1e-8, weight decay
    1e-4) with f32 moments, the parameters rounded to their dtype."""
    from ompi_release_tpu_torch.optim import (
        ADAMW_BETAS, ADAMW_EPS, ADAMW_WEIGHT_DECAY)
    from ompi_release_tpu_torch.utils import pytree

    b1, b2 = ADAMW_BETAS
    t = int(state["t"]) + 1
    ps, treedef = pytree.flatten(state["params"])
    ms, vs = pytree.leaves(state["m"]), pytree.leaves(state["v"])
    gs = pytree.leaves(grads)
    new_p, new_m, new_v = [], [], []
    for p, m, v, g in zip(ps, ms, vs, gs):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        u = (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + ADAMW_EPS)
        p32 = p.float()
        new_p.append((p32 - lr * (u + ADAMW_WEIGHT_DECAY * p32)).to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return {"params": pytree.unflatten(treedef, new_p),
            "m": pytree.unflatten(treedef, new_m),
            "v": pytree.unflatten(treedef, new_v),
            "t": torch.full_like(state["t"], t),
            "isum": state["isum"]}


def s13_train(w, mode, rt, tpvar, torch, cuda_op, dev, pidx, out_dir):
    """Jobs A and B: ElasticStep over a data-parallel train step of the
    full-width TpuLM (seed-0 weights, flash attention). Each local rank
    takes its own (1, 2048) batch, the 66 per-layer f32 gradients are
    summed over the spanning comm by the tree pass, AdamW ends the step;
    each rank's (step + 1) * (world rank + 1) and loss ride a 16-byte
    allreduce. Checkpoints every S13_CKPT_EVERY steps into this process's
    own directory."""
    import os

    from ompi_release_tpu_torch.coll import plan as cplan
    from ompi_release_tpu_torch.ft import Checkpointer, ulfm
    from ompi_release_tpu_torch.ft.sensor import FtTester
    from ompi_release_tpu_torch.models.transformer import (
        ModelConfig, TpuLM, forward_loss)
    from ompi_release_tpu_torch.optim import leaves
    from ompi_release_tpu_torch.parallel import tree as tree_mod
    from ompi_release_tpu_torch.parallel.elastic import ElasticStep
    from ompi_release_tpu_torch.utils import pytree

    steps = (S13_A if mode == "A" else S13_B)[0]
    cfg = ModelConfig()
    ps, treedef = pytree.flatten(TpuLM(cfg, seed=0, device=dev).params())

    def moments():
        return pytree.unflatten(treedef, [
            torch.zeros(p.shape, dtype=torch.float32, device=dev)
            for p in ps])

    state0 = {"params": pytree.unflatten(treedef,
                                         [p.detach() for p in ps]),
              "m": moments(), "v": moments(),
              "t": torch.zeros((), dtype=torch.int64, device=dev),
              "isum": torch.zeros((), dtype=torch.float64, device=dev)}
    rec = {"loss": {}, "ck": {}, "entry_ck": {}, "ms": {}, "err": []}

    def step_fn(step, state, comm):
        t0 = time.perf_counter()
        rec["entry_ck"].setdefault(step, []).append(
            s13_checksum(torch, state["params"]))
        wrs = [comm.group.world_rank(i) for i in comm.local_comm_ranks]
        ps, treedef = pytree.flatten(state["params"])
        live = [p.detach().requires_grad_(True) for p in ps]
        P = pytree.unflatten(treedef, live)
        per_rank, losses = [], []
        for wr in wrs:
            tok, tgt = s13_batch(torch, cfg, step, wr, dev)
            loss = forward_loss(cfg, P, tok, tgt)
            per_rank.append(torch.autograd.grad(loss, live))
            losses.append(loss.detach().double())
        # the 66 per-layer gradients, f32, one row per local rank
        g_tree = pytree.unflatten(treedef, [
            torch.stack([g[i].float() for g in per_rank])
            for i in range(len(live))])
        flat = s13_unstack(g_tree)
        try:
            red = tree_mod.TreeSync(comm, mean=False).issue(flat).wait()
            small = torch.stack([torch.stack([
                torch.tensor(float((step + 1) * (wr + 1)),
                             dtype=torch.float64, device=dev), lo])
                for wr, lo in zip(wrs, losses)])
            tot = comm.allreduce(small)[0]
        except Exception:
            rec["err"].append(time.time())
            raise
        n = comm.size
        layers = {name: torch.stack([red[f"{name}{l}"][0] / n
                                     for l in range(t.shape[1])])
                  for name, t in g_tree["layers"].items()}
        grads = {"embed": red["embed"][0] / n, "ln_f": red["ln_f"][0] / n,
                 "layers": layers}
        new = s13_adamw(torch, state, grads)
        new["isum"] = state["isum"] + tot[0]
        torch.cuda.synchronize(dev)
        rec["loss"][step] = float(tot[1]) / n
        rec["ck"][step] = s13_checksum(torch, new["params"])
        rec["ms"][step] = (time.perf_counter() - t0) * 1e3
        return new

    tester = FtTester.from_cvars(pidx)
    if tester.kill_step >= 0:
        kill = tester.kill_now

        def kill_now(why=""):
            with open(os.path.join(out_dir, f"kill-{mode}"), "w") as f:
                f.write(repr(time.time()))
            kill(why)

        tester.kill_now = kill_now
    ck = Checkpointer(os.path.join(out_dir, "ckpt", f"rank{pidx}"))
    es = ElasticStep(w, step_fn, ck,
                     policy="shrink" if mode == "A" else "respawn",
                     checkpoint_every=S13_CKPT_EVERY, recover_timeout_s=180,
                     tester=tester)
    world_cids = (w.cid, w._hier_module.shadow.cid)
    cuda_op.reset_launches()
    state, stats = es.run(state0, steps)
    torch.cuda.synchronize(dev)
    launches = dict(cuda_op.LAUNCHES)
    c = es.comm
    # the revoked world's plans (its own and its hier shadow's) are gone
    left = ([k for k in cplan._device_plans if k[0] in world_cids]
            + [k for k in cplan._span_states if k[0] in world_cids]
            + [c_ for c_ in cplan._pools if c_ in world_cids])
    if stats["recoveries"]:
        check(not left, f"slice 13 ({mode}): the revoked world's frozen "
                        f"plans outlived it: {left}")
        check(cplan.capture_lock.acquire(blocking=False),
              f"slice 13 ({mode}): the capture lock is held after the "
              "recovery")
        cplan.capture_lock.release()
    return {
        "steps": steps, "recoveries": stats["recoveries"],
        "failures": [f for _s, f in stats["failures"]],
        "failure_steps": [s for s, _f in stats["failures"]],
        "steps_lost": stats["steps_lost"],
        "comm_size": c.size, "comm_local": len(c.local_comm_ranks),
        "comm_cid": c.cid, "comm_name": c.name,
        "ft_band": [ulfm.FT_CID_BASE, ulfm.FT_CID_LIMIT],
        "isum": float(state["isum"]),
        "loss": rec["loss"], "ck": rec["ck"], "entry_ck": rec["entry_ck"],
        "ms": rec["ms"], "err_time": rec["err"],
        "final_ck": s13_checksum(torch, state["params"]),
        "launches": {k: launches[k] for k in
                     ("sum", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")},
        "pv": {n: float(tpvar.PVARS.lookup(n).read()) for n in (
            "ft_failures_detected", "ft_recoveries", "ft_revokes",
            "ft_recovery_seconds", "ft_steps_lost")},
    }


def s13_native(w, tpvar, torch, dev, pidx, out_dir):
    """Job C: a 16 B allreduce (the smallest payload the C executor's
    provenance probe takes: 16-byte windows) frozen and fired by the C
    executor, then worker 2 dies between fires; the survivors' next fire
    must surface the typed error, the C loop stopped by its raised fault
    word."""
    import os
    import signal

    def row(r):
        return [r + 1, 2 * r, 3, r * r]

    off = pidx * S13_RANKS
    x = torch.tensor([row(off + i) for i in range(S13_RANKS)],
                     dtype=torch.int32, device=dev)
    want = torch.tensor([sum(c) for c in zip(*map(row, range(S13_N)))],
                        dtype=torch.int32, device=dev)
    for _ in range(4):  # record, freeze, then replays in C
        got = w.allreduce(x)
        check(bits_equal(got[0], want), "slice 13 (C): the 16 B allreduce "
                                        "differs from its closed form")
    fires = float(tpvar.PVARS.lookup("plan_native_fires").read())
    check(fires >= 1, f"slice 13 (C): the C executor fired {fires} times")
    w.barrier()
    if pidx == 2:
        time.sleep(0.5)  # the survivors are inside their next fire
        with open(os.path.join(out_dir, "kill-C"), "w") as f:
            f.write(repr(time.time()))
        os.kill(os.getpid(), signal.SIGKILL)
    from ompi_release_tpu_torch.utils.errors import MPIError

    try:
        for _ in range(200):
            w.allreduce(x)
        check(False, "slice 13 (C): fires with a dead peer kept running")
    except MPIError as e:
        t_err = time.time()
        code, msg = e.code.name, str(e)
    check(code in ("ERR_PROC_FAILED", "ERR_REVOKED"),
          f"slice 13 (C): the fire raised {code}: {msg}")
    return {"code": code, "message": msg[:160], "err_time": t_err,
            "native_fires": fires,
            "ft_stops": float(
                tpvar.PVARS.lookup("plan_native_ft_stops").read())}


def s13_process_start():
    """This process's start on the wall clock: now, less its age (the
    clock since boot less its start in clock ticks since boot, both
    from boot, so good to a tick, 10 ms)."""
    import os

    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    age = (time.clock_gettime(time.CLOCK_BOOTTIME)
           - start / os.sysconf("SC_CLK_TCK"))
    return time.time() - age


def s13_worker():
    """One worker of a slice-13 job (``chip_smoke.py --slice13-worker``
    under ``tools.tpurun``): writes its results as JSON to
    ``$CHIP_SMOKE_S13_OUT/worker<process index>-<incarnation>.json``."""
    import os

    t_proc = s13_process_start()
    import torch

    import ompi_release_tpu_torch as mpi
    from ompi_release_tpu_torch.mca import pvar as tpvar
    from ompi_release_tpu_torch.ops import cuda_op
    from ompi_release_tpu_torch.runtime.runtime import Runtime

    mode = os.environ["CHIP_SMOKE_S13_MODE"]  # A | B | C
    out_dir = os.environ["CHIP_SMOKE_S13_OUT"]
    w = mpi.init(cli_args=["--mca", "runtime_virtual_ranks", str(S13_RANKS),
                           "--mca", "coll", "tuned,basic,self,hier"])
    t_init = time.time()
    rt = Runtime.current()
    pidx = int(rt.bootstrap["process_index"])
    dev = w.device
    inc = int(os.environ.get("OMPITPU_INCARNATION", "0") or 0)
    check(w.size == S13_N and w.spans_processes and dev.type == "cuda",
          f"slice 13: WORLD {w.size} ranks on {dev}")
    torch.cuda.reset_peak_memory_stats(dev)
    out = {"pidx": pidx, "pid": os.getpid(), "mode": mode,
           "incarnation": inc, "t_proc": t_proc, "t_init": t_init}
    if mode == "C":
        out.update(s13_native(w, tpvar, torch, dev, pidx, out_dir))
    else:
        out.update(s13_train(w, mode, rt, tpvar, torch, cuda_op, dev, pidx,
                             out_dir))
    torch.cuda.synchronize(dev)
    out["peak_device_memory_GiB"] = \
        torch.cuda.max_memory_allocated(dev) / 2 ** 30
    out["seconds"] = time.time() - t_proc
    with open(os.path.join(out_dir, f"worker{pidx}-{inc}.json"), "w") as f:
        json.dump(out, f)
    mpi.finalize()
    return 0


def s13_job(mode, job_kw, out_dir):
    """One slice-13 job (3 workers x 2 virtual ranks on cuda:0,
    heartbeats every 0.3 s, miss limit 3); returns (rc, wall seconds,
    the job, {(pidx, incarnation): results}, the kill time or None)."""
    import os

    rc, wall, job, res = run_slice_job(
        13, mode, S13_PROCS, out_dir, job_kw=job_kw,
        heartbeat_s=S13_HEARTBEAT_S, miss_limit=S13_MISS_LIMIT,
        every=False)
    kill = None
    if os.path.exists(os.path.join(out_dir, f"kill-{mode}")):
        with open(os.path.join(out_dir, f"kill-{mode}")) as f:
            kill = float(f.read())
    return rc, wall, job, {(r["pidx"], r["incarnation"]): r
                           for r in res}, kill


def s13_closed_isum(steps, kill, degraded):
    """The integer contributions' sum: every step on the 6 ranks (sum of
    wr + 1 = 21), or from the killed step on the 4 survivors (10)."""
    cut = kill if degraded else steps
    return float(sum((s + 1) * 21 for s in range(cut))
                 + sum((s + 1) * 10 for s in range(cut, steps)))


def phase_slice13(cuda_op, torch):
    """Slice 13's path: jobs C (the C executor's fault word), A (shrink)
    and B (respawn), each held to the checks the module docstring lists; the
    checkpoint directories live in a temporary directory removed with
    it. Returns what ``report_slice13`` prints and the launches per
    kernel row summed over the workers."""
    import gc
    import tempfile

    from ompi_release_tpu_torch.native import build_library

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cuda_op.build()
    build_library()
    out = {}
    with tempfile.TemporaryDirectory() as td:
        rc, wall, job, res, kill = s13_job(
            "C", {"on_failure": "continue"}, td)
    check(rc == 0, f"slice 13 (C): the job exited {rc}")
    check(sorted(res) == [(0, 0), (1, 0)] and job._ft_failed_ranks == {3},
          f"slice 13 (C): results {sorted(res)}, promoted "
          f"{job._ft_failed_ranks}")
    check(sum(r["ft_stops"] for r in res.values()) >= 1,
          "slice 13 (C): no C fire stopped on its raised fault word")
    out["C"] = {"wall": wall, "kill": kill, "res": res}
    for r in res.values():
        check(r["err_time"] - kill < S13_DETECT_S,
              f"slice 13 (C): worker {r['pidx']} saw the typed error "
              f"{r['err_time'] - kill:.2f} s after the kill")

    with tempfile.TemporaryDirectory() as td:
        rc, wall, job, res, kill = s13_job(
            "A", {"on_failure": "continue", "ft_inject": (2, S13_A[1])}, td)
    check(rc == 0, f"slice 13 (A): the job exited {rc}")
    check(sorted(res) == [(0, 0), (1, 0)] and kill is not None,
          f"slice 13 (A): results {sorted(res)}, kill {kill}")
    steps, kstep = S13_A
    isum = s13_closed_isum(steps, kstep, True)
    for r in res.values():
        w_ = r["pidx"]
        check(r["recoveries"] == 1 and r["failure_steps"] == [kstep]
              and any(c in r["failures"][0] for c in
                      ("ERR_PROC_FAILED", "ERR_REVOKED")),
              f"slice 13 (A): worker {w_} failures {r['failures']}")
        check(r["err_time"] and r["err_time"][0] - kill < S13_DETECT_S,
              f"slice 13 (A): worker {w_} detected "
              f"{r['err_time'][0] - kill:.2f} s after the kill")
        lo, hi = r["ft_band"]
        check(r["comm_size"] == 4 and r["comm_local"] == 2
              and lo <= r["comm_cid"] < hi,
              f"slice 13 (A): shrunk comm size {r['comm_size']} cid "
              f"{r['comm_cid']}")
        last = str(kstep - 1)  # the committed step before the kill
        check(all(ck == r["ck"][last] for ck in r["entry_ck"][str(kstep)]),
              f"slice 13 (A): worker {w_}: the rollback did not restore "
              "step {last} bitwise")
        check(r["isum"] == isum,
              f"slice 13 (A): integer sum {r['isum']} != {isum}")
        losses = [r["loss"][str(s)] for s in range(steps)]
        check(all(math.isfinite(x) for x in losses)
              and losses[-1] < losses[0],
              f"slice 13 (A): worker {w_} losses {losses}")
        check(r["pv"]["ft_failures_detected"] == 1
              and r["pv"]["ft_recoveries"] == 1,
              f"slice 13 (A): worker {w_} pvars {r['pv']}")
    finals = {tuple(r["final_ck"]) for r in res.values()}
    check(len(finals) == 1, f"slice 13 (A): survivors' final parameters "
                            f"differ: {finals}")
    out["A"] = {"wall": wall, "kill": kill, "res": res}

    with tempfile.TemporaryDirectory() as td:
        rc, wall, job, res, kill = s13_job(
            "B", {"on_failure": "restart", "max_restarts": 2,
                  "ft_inject": (2, S13_B[1])}, td)
    check(rc == 0, f"slice 13 (B): the job exited {rc}")
    check(sorted(res) == [(0, 0), (1, 0), (2, 1)] and kill is not None
          and job._restarts == {3: 1},
          f"slice 13 (B): results {sorted(res)}, restarts {job._restarts}")
    steps, kstep = S13_B
    isum = s13_closed_isum(steps, kstep, False)
    a_any = next(iter(out["A"]["res"].values()))
    for r in res.values():
        w_ = r["pidx"]
        check(r["comm_size"] == S13_N and r["comm_name"].startswith(
              "rebuild"), f"slice 13 (B): worker {w_} comm "
                          f"{r['comm_name']} size {r['comm_size']}")
        check(r["isum"] == isum,
              f"slice 13 (B): integer sum {r['isum']} != {isum}")
        for s in (str(kstep), str(kstep + 1)):
            check(r["loss"][s] == a_any["loss"][s]
                  and r["ck"][s] == a_any["ck"][s],
                  f"slice 13 (B): worker {w_} step {s}: loss "
                  f"{r['loss'][s]} / checksum {r['ck'][s]} are not job "
                  f"A's {a_any['loss'][s]} / {a_any['ck'][s]}")
    rep = res[(2, 1)]
    out["B"] = {"wall": wall, "kill": kill, "res": res,
                "rejoin_s": rep["t_init"] - kill,
                "cold_start_s": rep["t_init"] - rep["t_proc"]}
    sums = {name: sum(r["launches"][name] for j in ("A", "B")
                      for r in out[j]["res"].values())
            for name in ("sum", "flash_fwd", "flash_bwd_dq",
                         "flash_bwd_dkv")}
    for name, n in sums.items():
        check(n > 0, f"slice 13: {name} launched no time")
    out["launches"] = sums
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 3: slice-13 path: C (fault word), A (shrink) and B "
        f"(respawn) passed; launches {sums}; the phase took "
        f"{out['seconds']:.1f} s")
    return out


def report_slice13(s13):
    """Slice 13's numbers per job and worker, each beside the card's name
    and power limit."""
    card = card_line()
    for job in ("C", "A", "B"):
        j = s13[job]
        for (pidx, inc), r in sorted(j["res"].items()):
            row = {"s13_job": job, "worker": pidx, "incarnation": inc,
                   "card": card,
                   "peak_device_memory_GiB": r["peak_device_memory_GiB"],
                   "seconds": r["seconds"]}
            if job == "C":
                row.update(detect_s=r["err_time"] - j["kill"],
                           code=r["code"], ft_stops=r["ft_stops"],
                           native_fires=r["native_fires"])
            else:
                kstep = (S13_A if job == "A" else S13_B)[1]
                ms = {int(s): v for s, v in r["ms"].items()}
                before = [v for s, v in ms.items() if s < kstep]
                after = [v for s, v in ms.items() if s > kstep]
                row.update(
                    detect_s=(r["err_time"][0] - j["kill"]
                              if r["err_time"] else None),
                    ft_recovery_seconds=r["pv"]["ft_recovery_seconds"],
                    steps_lost=r["steps_lost"],
                    ms_per_step_before=(statistics.median(before)
                                        if before else None),
                    ms_per_step_after=(statistics.median(after)
                                       if after else None),
                    losses=[r["loss"][str(s)] for s in
                            sorted(int(k) for k in r["loss"])],
                    launches=r["launches"], pv=r["pv"])
            log(json.dumps(row))
        extra = {}
        if job == "B":
            extra = {"kill_to_rejoined_s": j["rejoin_s"],
                     "replacement_cold_start_s": j["cold_start_s"]}
        log(json.dumps({"s13_job": job, "job_wall_s": j["wall"], **extra,
                        "card": card}))


# ---------------------------------------------------------------------------
# slice 14: the observability plane over a spanning job and the TpuLM
# ---------------------------------------------------------------------------

S14_PROCS = 2
S14_RANKS = 4  # virtual ranks a worker owns on cuda:0
S14_N = S14_PROCS * S14_RANKS
#: the spanning allreduce sizes per rank (f32): 8 B, 256 KiB, 4 MiB, 256 MiB
S14_SIZES = (8, 256 * 1024, 4 * MIB, 256 * MIB)
S14_FIRES = 3  # record, then two replays per size and obs state
S14_NAMED_ELEMS = 3 * 1024  # the allreduce worker 1 arrives 2 s late to
S14_LATE_S = 2.0
S14_TURNS = 7  # interleaved turns per overhead ratio (median)
S14_TURN_FIRES = 20  # 256 KiB replays per turn and obs state
S14_SENTINEL_CALLS = 100  # in-process 1 MiB allreduces per turn and level
S14_P2P_BYTES = 8 * MIB  # shm-ring ping-pong for the event-ring ratio
S14_P2P_TRIPS = 16  # round trips per turn and ring state
S14_STALL_S = 1.5  # the second job's obs_stall_timeout
#: the budgets the reference holds the overhead ratios to: the obs plane
#: on a replayed 256 KiB spanning allreduce (bench.py:1365-1370), the C
#: event ring on shm-ring p2p (bench.py:2335-2341)
S14_OBS_BUDGET = 1.15
S14_EVENTS_BUDGET = 1.05
#: the postmortem's state contributors the flight recorder must carry
S14_CONTRIBUTORS = ("journal_tail", "ledger_tail", "sentinel",
                    "frozen_plans", "native_rings", "nbc_inflight",
                    "hier_rounds", "ft_state")


def s14_wait_file(path, timeout_s=120.0):
    import os

    t_end = time.monotonic() + timeout_s
    while not os.path.exists(path):
        check(time.monotonic() < t_end, f"slice 14: {path} never appeared")
        time.sleep(0.05)


def s14_allreduces(w, cplan, torch, off, dev):
    """(a): the spanning allreduce at every S14_SIZES size, S14_FIRES
    fires (interpreted, then replayed from the frozen wire plan), and the
    tuned allreduce on this worker's shadow comm; returns the outputs and
    the replay executors."""
    shadow = w._hier_module.shadow
    outs, lasts = {}, {}
    for nbytes in S14_SIZES:
        count = max(1, nbytes // 4)
        x = s10_rows(torch, count, off, dev)
        want = s10_sum(torch, count, dev)
        for k in range(S14_FIRES):
            got = w.allreduce(x)
            check(bits_equal(got, want.expand(S14_RANKS, count)
                             .contiguous()),
                  f"slice 14: the {nbytes} B spanning allreduce differs "
                  "from its closed form")
            st = s11_state(cplan, w, "allreduce", (x,))
            lasts[(nbytes, k)] = st.last
        outs[("span", nbytes)] = got
        loc = None
        for _ in range(S14_FIRES):
            loc = shadow.allreduce(x)
        outs[("shadow", nbytes)] = loc
        del x
    return outs, lasts


def s14_records(obs, ledger, w, torch, off, dev):
    """Check 7's witness: a fresh 256 KiB-class signature fired once
    interpreted, then replayed; the interpreted fire's journal message
    spans and the replayed fire's ledger record, expanded, agree by kind
    and count (per op and peer), and the replay journals no message
    span of its own."""
    import collections

    x = s10_rows(torch, 65 * 1024, off, dev)  # a signature of its own
    me = w._hier_module.my_pidx

    def msgs(spans):
        return collections.Counter(
            (s["op"], s["peer"]) for s in spans
            if s["op"] in ("hier_send", "hier_recv"))

    def spanning(since):
        return [r for r in ledger.records(since)
                if r["kind"] == ledger.KIND_SPANNING and r["cid"] == w.cid]

    def mine(since):
        return [s.asdict() for s in obs.journal.snapshot()
                if s.seq >= since and s.comm_id == w.cid]

    s0 = obs.journal.total_recorded
    r0 = max([r["seq"] for r in ledger.records()], default=-1)
    w.allreduce(x)  # interpreted (records the plan)
    interp = mine(s0)
    check(not spanning(r0), "slice 14: the interpreted fire left a "
                            "spanning ledger record")
    s1 = obs.journal.total_recorded
    w.allreduce(x)  # replayed
    replay = mine(s1)
    recs = spanning(r0)
    check(len(recs) == 1, f"slice 14: the replay left {len(recs)} "
                          "spanning ledger records")
    plans = {str(k): v for k, v in ledger.plans().items()}
    expanded = ledger.expand_record(recs[0], plans, me)
    check(not msgs(replay), "slice 14: the replayed fire journaled "
                            "message spans")
    want, got = msgs(interp), msgs(expanded)
    check(want and want == got,
          f"slice 14: a replay's ledger expansion {dict(got)} is not the "
          f"interpreted fire's journal {dict(want)}")
    coll = [sum(1 for s in sp if s["layer"] == "coll"
                and s["op"] == "allreduce") for sp in (interp, replay)]
    check(coll == [1, 1], f"slice 14: coll spans interpreted | replayed "
                          f"{coll}")
    return {"messages": sum(want.values()),
            "by_op": dict(collections.Counter(k[0] for k in
                                              want.elements())),
            "round_ts": len(recs[0]["round_ts"])}


def s14_model(w, torch, dev, steps):
    """(b): the full-width TpuLM from seed-0 weights: one eval forward
    and ``steps`` data-parallel AdamW steps over the spanning world, each
    local rank a (1, 2048) Zipf batch, the 66 per-layer f32 gradients
    summed by the tree pass (slice 13's step). Returns the eval loss and
    each step's loss and parameter checksum."""
    from ompi_release_tpu_torch.models.transformer import (
        ModelConfig, TpuLM, forward_loss)
    from ompi_release_tpu_torch.parallel import tree as tree_mod
    from ompi_release_tpu_torch.utils import pytree

    cfg = ModelConfig()
    ps, treedef = pytree.flatten(TpuLM(cfg, seed=0, device=dev).params())
    zeros = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
             for p in ps]
    state = {"params": pytree.unflatten(treedef, [p.detach() for p in ps]),
             "m": pytree.unflatten(treedef, zeros),
             "v": pytree.unflatten(treedef, [z.clone() for z in zeros]),
             "t": torch.zeros((), dtype=torch.int64, device=dev),
             "isum": torch.zeros((), dtype=torch.float64, device=dev)}
    wrs = [w.group.world_rank(i) for i in w.local_comm_ranks]
    n = w.size
    with torch.no_grad():
        losses = [forward_loss(cfg, state["params"],
                               *s13_batch(torch, cfg, 99, wr, dev)).double()
                  for wr in wrs]
    ev = w.allreduce(torch.stack(losses)[:, None].expand(
        len(wrs), 2).contiguous())[0, 0]
    out = {"eval_loss": float(ev) / n, "loss": [], "ck": [], "step_s": []}
    for step in range(steps):
        torch.cuda.synchronize(dev)
        t_step = time.perf_counter()
        ps, treedef = pytree.flatten(state["params"])
        live = [p.detach().requires_grad_(True) for p in ps]
        P = pytree.unflatten(treedef, live)
        per_rank, losses = [], []
        for wr in wrs:
            tok, tgt = s13_batch(torch, cfg, step, wr, dev)
            loss = forward_loss(cfg, P, tok, tgt)
            per_rank.append(torch.autograd.grad(loss, live))
            losses.append(loss.detach().double())
        g_tree = pytree.unflatten(treedef, [
            torch.stack([g[i].float() for g in per_rank])
            for i in range(len(live))])
        red = tree_mod.TreeSync(w, mean=False).issue(
            s13_unstack(g_tree)).wait()
        tot = w.allreduce(torch.stack(losses)[:, None].expand(
            len(wrs), 2).contiguous())[0, 0]
        layers = {name: torch.stack([red[f"{name}{l}"][0] / n
                                     for l in range(t.shape[1])])
                  for name, t in g_tree["layers"].items()}
        grads = {"embed": red["embed"][0] / n, "ln_f": red["ln_f"][0] / n,
                 "layers": layers}
        state = s13_adamw(torch, state, grads)
        torch.cuda.synchronize(dev)
        out["step_s"].append(time.perf_counter() - t_step)
        out["loss"].append(float(tot) / n)
        out["ck"].append(s13_checksum(torch, state["params"]))
    return out


def s14_profile_split(w, obs, fire):
    """The added host time of one fire by module: S14_TURN_FIRES fires
    under cProfile with the plane on, as many with it off, each
    module's own time (tottime) on minus off, per fire in µs. cProfile
    inflates every call, so the split is read as shares; ``added_us`` is
    the profiled wall time on minus off, per fire."""
    import cProfile
    import collections
    import os
    import pstats

    root = os.path.dirname(os.path.abspath(__file__))

    def group(path):
        if path == "~":
            return "builtins"
        rel = os.path.relpath(path, root)
        if rel.startswith("ompi_release_tpu_torch" + os.sep):
            return rel.split(os.sep, 1)[1]
        return "other"

    def window(on):
        (obs.enable if on else obs.disable)()
        w.barrier()
        pr = cProfile.Profile()
        t0 = time.perf_counter()
        pr.enable()
        for _ in range(S14_TURN_FIRES):
            fire()
        pr.disable()
        wall = time.perf_counter() - t0
        by = collections.Counter()
        for (path, _line, _fn), row in pstats.Stats(pr).stats.items():
            by[group(path)] += row[2]
        return wall, by

    wall_on, on = window(True)
    wall_off, off_ = window(False)
    obs.enable()
    delta = {g: (on[g] - off_[g]) / S14_TURN_FIRES * 1e6
             for g in set(on) | set(off_)}
    top = dict(sorted(delta.items(), key=lambda kv: -abs(kv[1]))[:12])
    return {"added_us": (wall_on - wall_off) / S14_TURN_FIRES * 1e6,
            "obs_modules_us": sum(v for g, v in delta.items()
                                  if g.startswith("obs" + os.sep)),
            "by_module_us": top}


def s14_overheads(w, rt, obs, nativeev, torch, off, dev, pidx, cplan):
    """The in-job overhead ratios, each leg's median over S14_TURNS
    interleaved turns of S14_TURN_FIRES replays of the 256 KiB spanning
    allreduce, the plane on against off:
    - ``obs_ratio``, the budget's comparison (bench.py:1331-1371): at
      ``obs_sentinel`` 0, on the executor the replays take (``obs_exec``:
      the C executor where it compiles);
    - ``obs_s2_ratio``, the slice's own setting, ``obs_sentinel`` 2: both
      legs on PlannedXchg (the C executor withdraws at level 2), the
      on leg with the inline signature exchange, timed alone beside it
      (``WireRouter.sentinel_exchange``, the plane off);
    - ``split``: one level-2 fire's added time by module
      (``s14_profile_split``);
    and 8 MiB ping-pongs over the shm ring with the C event ring
    installed and not (the Python plane off in both legs)."""
    from ompi_release_tpu_torch.mca import var as tmvar
    from ompi_release_tpu_torch.obs import sentinel

    x = s10_rows(torch, 256 * 1024 // 4, off, dev)

    def fire():
        w.allreduce(x)

    def fires():
        w.barrier()
        t0 = time.perf_counter()
        for _ in range(S14_TURN_FIRES):
            fire()
        return (time.perf_counter() - t0) / S14_TURN_FIRES * 1e3

    def legs(level):
        # a cvar write re-records the plan at the next fire; the timed
        # fires are replays
        tmvar.set_value("obs_sentinel", level)
        sentinel.refresh()
        fire()
        fire()
        on, off_, ex = [], [], set()
        for _ in range(S14_TURNS):
            obs.enable()
            on.append(fires())
            ex.add(("on", s11_state(cplan, w, "allreduce", (x,)).last))
            obs.disable()
            off_.append(fires())
            ex.add(("off", s11_state(cplan, w, "allreduce", (x,)).last))
        obs.enable()
        return on, off_, sorted(ex)

    on0, off0, ex0 = legs(0)
    why0 = s11_state(cplan, w, "allreduce", (x,)).why
    on, off_, ex2 = legs(2)
    check(sentinel.mode() == 2, "slice 14: the inline sentinel is off")
    split = s14_profile_split(w, obs, fire)
    canon = sentinel.make_canon("allreduce", "sum", "float32", 65536, -1)
    sig = sentinel.CallSig(w.cid, 0, "allreduce", canon, 0,
                           "chip_smoke.py:0", 0)
    payload = sentinel.InlineFrameTemplate(canon, sig.site).render(sig)

    def exchanges():
        w.barrier()
        t0 = time.perf_counter()
        for _ in range(S14_TURN_FIRES):
            rt.wire.sentinel_exchange(w, payload)
        return (time.perf_counter() - t0) / S14_TURN_FIRES * 1e3

    obs.disable()
    exch = [exchanges() for _ in range(S14_TURNS)]
    obs.enable()
    ring = nativeev.get_ring()
    check(ring is not None, "slice 14: the native event ring is off")
    msg = s10_pattern(torch, S14_P2P_BYTES // 4, 0, dev)

    def trips():
        w.barrier()
        t0 = time.perf_counter()
        for _ in range(S14_P2P_TRIPS):
            if pidx == 0:
                w.send(msg, dest=4, tag=31, rank=0)
                w.recv(source=4, tag=32, rank=0)
            else:
                v, _st = w.recv(source=0, tag=31, rank=4)
                w.send(v, dest=0, tag=32, rank=4)
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) / S14_P2P_TRIPS * 1e3

    ev_on, ev_off = [], []
    n0 = ring.count()
    for _ in range(S14_TURNS):
        ring.install()
        ev_on.append(trips())
        ring.uninstall()
        ev_off.append(trips())
    ring.install()
    obs.enable()
    check(ring.count() > n0, "slice 14: the event ring recorded no "
                             "fragment of the ping-pongs")
    med = statistics.median
    return {"obs_on_ms": med(on0), "obs_off_ms": med(off0),
            "obs_ratio": med(on0) / med(off0), "obs_exec": ex0,
            "obs_exec_why": why0,
            "obs_on_each": on0, "obs_off_each": off0,
            "obs_s2_on_ms": med(on), "obs_s2_off_ms": med(off_),
            "obs_s2_ratio": med(on) / med(off_), "obs_s2_exec": ex2,
            "obs_s2_on_each": on, "obs_s2_off_each": off_, "split": split,
            "inline_exchange_ms": med(exch), "inline_exchange_each": exch,
            "events_on_ms": med(ev_on), "events_off_ms": med(ev_off),
            "events_ratio": med(ev_on) / med(ev_off),
            "events_on_each": ev_on, "events_off_each": ev_off}


def s14_main(w, rt, obs, torch, cuda_op, dev, pidx, out_dir):
    """The main job's worker path (checks 1, 3, 4, 5 and 7; the parent
    holds checks 2 and 6 and the rest of 4 and 5)."""
    import collections
    import json as _json
    import os

    from ompi_release_tpu_torch.coll import plan as cplan
    from ompi_release_tpu_torch.obs import ledger, nativeev, sampler
    from ompi_release_tpu_torch.obs import sentinel

    off = rt.local_rank_offset
    out = {"clock_offset_s": obs.clock_offset(),
           "clock_rtt_s": obs._clock_state["rtt_s"],
           "sentinel_mode": sentinel.mode(),
           "sampler_running": sampler.SAMPLER.running(),
           "event_ring": nativeev.get_ring() is not None}
    check(obs.enabled and out["sentinel_mode"] == 2
          and out["sampler_running"] and out["event_ring"]
          and out["clock_offset_s"] is not None,
          f"slice 14: worker {pidx}'s plane is not up: {out}")
    # the parent pokes worker 1 with SIGUSR1 and queries tpu_ps now
    with open(os.path.join(out_dir, f"ready-{pidx}"), "w") as f:
        _json.dump({"pid": os.getpid()}, f)
    s14_wait_file(os.path.join(out_dir, "go"))
    w.barrier()
    cuda_op.reset_launches()
    t0 = time.perf_counter()
    # (a) with the plane on, then the same job's calls with obs.disable()
    on, lasts = s14_allreduces(w, cplan, torch, off, dev)
    out["executors"] = {f"{b}:{k}": v for (b, k), v in lasts.items()}
    for nbytes in S14_SIZES:
        check([lasts[(nbytes, k)] for k in range(S14_FIRES)]
              == ["interpreted"] + ["planned"] * (S14_FIRES - 1),
              f"slice 14: the {nbytes} B fires ran "
              f"{[lasts[(nbytes, k)] for k in range(S14_FIRES)]}")
    sum_on = cuda_op.LAUNCHES["sum"]
    obs.disable()
    off_outs, _ = s14_allreduces(w, cplan, torch, off, dev)
    obs.enable()
    for key, got in on.items():
        check(bits_equal(got, off_outs[key]),
              f"slice 14: the {key} allreduce with obs on differs from "
              "the same call with obs off")
    del on, off_outs
    out["records"] = s14_records(obs, ledger, w, torch, off, dev)
    # the named round: worker 1 arrives S14_LATE_S late. The wait sits
    # in the inline sentinel's signature exchange, inside the round's
    # coll span, which opens at arrival
    if pidx == 1:
        time.sleep(S14_LATE_S)
    w.allreduce(s10_rows(torch, S14_NAMED_ELEMS, off, dev))
    out["phase_a_s"] = time.perf_counter() - t0
    # (b) the TpuLM with the plane on, then again with obs.disable()
    t0 = time.perf_counter()
    m_on = s14_model(w, torch, dev, 2)
    flash = {k: cuda_op.LAUNCHES[k] for k in
             ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    obs.disable()
    m_off = s14_model(w, torch, dev, 2)
    obs.enable()
    check(m_on["loss"][1] == m_off["loss"][1]
          and m_on["ck"][1] == m_off["ck"][1]
          and m_on["eval_loss"] == m_off["eval_loss"],
          f"slice 14: the TpuLM with obs on (loss {m_on['loss']}, "
          f"checksum {m_on['ck'][1]}) differs from obs off "
          f"({m_off['loss']}, {m_off['ck'][1]})")
    check(all(math.isfinite(v) for v in m_on["loss"])
          and abs(m_on["eval_loss"] - math.log(32000)) < 1.0,
          f"slice 14: TpuLM losses {m_on}")
    out["model"] = m_on
    out["phase_b_s"] = time.perf_counter() - t0
    out["overheads"] = s14_overheads(w, rt, obs, nativeev, torch, off,
                                     dev, pidx, cplan)
    torch.cuda.synchronize(dev)
    out["launches"] = {"stream_axpy[sum]": sum_on, **flash}
    out["launches_all"] = dict(cuda_op.LAUNCHES)
    check(sum_on > 0 and all(v > 0 for v in flash.values()),
          f"slice 14: worker {pidx} launches {out['launches']}")
    out["spans_by_layer"] = dict(collections.Counter(
        s.layer for s in obs.journal.snapshot()))
    out["journal_dropped"] = obs.journal.dropped
    w.barrier()
    return out


def s14_desync(w, rt, obs, torch, dev, pidx):
    """The second job: a posted bcast against an allreduce under the
    inline sentinel (every process raises ERR_COLL_MISMATCH in that
    round), the comm coherent after it, then a sleeping worker 1 that
    the other's stall watchdog reports."""
    from ompi_release_tpu_torch.obs import sentinel, watchdog
    from ompi_release_tpu_torch.utils.errors import ErrorCode, MPIError

    off = rt.local_rank_offset
    check(obs.enabled and sentinel.mode() == 2 and watchdog.enabled,
          "slice 14 (desync): the inline sentinel or the watchdog is off")
    x = s10_rows(torch, 64, off, dev)
    want = s10_sum(torch, 64, dev).expand(S14_RANKS, 64).contiguous()
    check(bits_equal(w.allreduce(x), want), "slice 14 (desync): the "
                                            "matching round differs")
    out = {}
    t0 = time.perf_counter()
    try:
        if pidx == 1:
            w.bcast(x, root=0)
        else:
            w.allreduce(x)
        check(False, f"slice 14 (desync): worker {pidx} did not raise")
    except MPIError as e:
        check(e.code == ErrorCode.ERR_COLL_MISMATCH,
              f"slice 14 (desync): worker {pidx} raised {e.code.name}")
        out["mismatch_s"] = time.perf_counter() - t0
        out["mismatch"] = str(e)
    check(bits_equal(w.allreduce(x), want), "slice 14 (desync): the round "
                                            "after the mismatch differs")
    # the stall, still under the inline sentinel: the watchdog arm of
    # the signature exchange names the allreduce and the absent ranks
    if pidx == 1:
        time.sleep(2 * S14_STALL_S)
    t0 = time.perf_counter()
    check(bits_equal(w.allreduce(x), want), "slice 14 (desync): the late "
                                            "round differs")
    out["stall_wait_s"] = time.perf_counter() - t0
    w.barrier()
    return out


def s14_worker():
    """One worker of a slice-14 job (``chip_smoke.py --slice14-worker``
    under ``tools.tpurun``): writes its results as JSON to
    ``$CHIP_SMOKE_S14_OUT/worker<process index>.json``."""
    import os

    import torch

    import ompi_release_tpu_torch as mpi
    from ompi_release_tpu_torch import obs
    from ompi_release_tpu_torch.ops import cuda_op
    from ompi_release_tpu_torch.runtime.runtime import Runtime

    mode = os.environ["CHIP_SMOKE_S14_MODE"]  # main | desync
    out_dir = os.environ["CHIP_SMOKE_S14_OUT"]
    t_start = time.perf_counter()
    w = mpi.init(cli_args=["--mca", "runtime_virtual_ranks", str(S14_RANKS),
                           "--mca", "coll", "tuned,basic,self,hier"])
    rt = Runtime.current()
    pidx = int(rt.bootstrap["process_index"])
    dev = w.device
    check(w.size == S14_N and w.spans_processes and dev.type == "cuda",
          f"slice 14: WORLD {w.size} ranks on {dev}")
    torch.cuda.reset_peak_memory_stats(dev)
    out = {"pidx": pidx, "pid": os.getpid(), "mode": mode}
    if mode == "main":
        out.update(s14_main(w, rt, obs, torch, cuda_op, dev, pidx,
                            out_dir))
    else:
        out.update(s14_desync(w, rt, obs, torch, dev, pidx))
    torch.cuda.synchronize(dev)
    out["peak_device_memory_GiB"] = \
        torch.cuda.max_memory_allocated(dev) / 2 ** 30
    out["seconds"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, f"worker{pidx}.json"), "w") as f:
        json.dump(out, f)
    mpi.finalize()  # the journal, series, ledger and nativeev dumps
    return 0


def s14_poke(out_dir, res):
    """The parent's side of the main job, on a thread: once both workers
    are up, query the live job with ``tpu_ps`` and send worker 1 a
    SIGUSR1, then let the workers go on."""
    import os
    import signal

    from ompi_release_tpu_torch.tools import tpu_ps

    try:
        pids = {}
        for p in range(S14_PROCS):
            path = os.path.join(out_dir, f"ready-{p}")
            s14_wait_file(path)
            with open(path) as f:
                pids[p] = json.load(f)["pid"]
        jobs = [j for j in tpu_ps.discover_jobs()
                if int(j.get("pid", -1)) == os.getpid()]
        check(len(jobs) == 1, f"slice 14: tpu_ps found {len(jobs)} jobs "
                              "of this launcher")
        t_end = time.monotonic() + 10.0
        while True:  # a row's pid and rss ride the workers' heartbeats
            cl = tpu_ps.PsClient(jobs[0]["host"], int(jobs[0]["port"]),
                                 secret=jobs[0].get("secret"))
            try:
                res["ps"] = cl.query()
            finally:
                cl.close()
            rows = res["ps"]["workers"].values()
            if all(r.get("rss") for r in rows) \
                    or time.monotonic() > t_end:
                break
            time.sleep(0.25)
        os.kill(pids[1], signal.SIGUSR1)
        res["usr1_pid"] = pids[1]
        res["pids"] = pids
    except BaseException as e:  # reported by the phase, never swallowed
        res["error"] = repr(e)
    finally:
        with open(os.path.join(out_dir, "go"), "w") as f:
            f.write("go")


def s14_check_dumps(dump_dir, pm_dir, poke):
    """Checks 2, 3 and 5 from the main job's files, through the port's
    doctor: the dumps, one merged trace with cross-process and native
    fragment flows, the late worker named, the contracts aligned, the
    SIGUSR1 postmortem with every contributor."""
    import glob
    import os

    from ompi_release_tpu_torch.obs import doctor
    from ompi_release_tpu_torch.tools import tpu_doctor

    for kind, ext in (("journal", "json"), ("series", "jsonl"),
                      ("ledger", "json"), ("nativeev", "json")):
        for p in range(S14_PROCS):
            path = os.path.join(dump_dir, f"{kind}-p{p}.{ext}")
            check(os.path.exists(path), f"slice 14: finalize wrote no "
                                        f"{os.path.basename(path)}")
    trace_path = os.path.join(dump_dir, "merged-trace.json")
    check(tpu_doctor.main(["merge", dump_dir, "-o", trace_path]) == 0,
          "slice 14: tpu_doctor merge failed")
    with open(trace_path) as f:
        od = json.load(f)["otherData"]
    dumps = doctor.load_dir(dump_dir)
    pairs = doctor.flow_pairs(dumps)
    native = [p for p in pairs if p["src"].get("nativeev")
              and p["dst"].get("nativeev")]
    check(od["processes"] == S14_PROCS and od["cross_process_flows"] > 0
          and native, f"slice 14: merged trace {od}, {len(native)} "
                      "paired native fragment flows")
    text, data = doctor.skew_report(dumps)
    late = max((r for r in data["rounds"] if r["op"] == "allreduce"),
               key=lambda r: r["spread_s"])
    check(late["slowest_pidx"] == 1 and late["spread_s"] > S14_LATE_S / 2,
          f"slice 14: the report's widest allreduce round {late}")
    ctext, cdata = doctor.contract_report(dumps, directory=dump_dir)
    check(cdata["divergences"] == 0, f"slice 14: contracts {ctext}")
    check("error" not in poke and "ps" in poke, f"slice 14: the poke "
                                                f"thread {poke}")
    pms = glob.glob(os.path.join(
        pm_dir, f"postmortem-p1-{poke['usr1_pid']}-sigusr1-*.json"))
    check(len(pms) == 1, f"slice 14: SIGUSR1 postmortems {pms}")
    with open(pms[0]) as f:
        pm = json.load(f)
    missing = [c for c in S14_CONTRIBUTORS
               if c not in pm or isinstance(pm[c], str)]
    check(not missing, f"slice 14: the postmortem lacks {missing}")
    ps = poke["ps"]
    workers = {str(p + 1): poke["pids"][p] for p in range(S14_PROCS)}
    for nid, pid in workers.items():
        row = ps["workers"].get(nid, {})
        check(row.get("pid") == pid and row.get("rss", 0) > 0
              and nid in ps.get("proc_states", {}),
              f"slice 14: tpu_ps row {nid}: {row}, states "
              f"{ps.get('proc_states')}")
    return {"merged": od, "native_pairs": len(native),
            "pairs": len(pairs), "late_round": late,
            "contracts": cdata["divergences"],
            "postmortem_keys": sorted(pm), "ps": ps,
            "report_head": text.splitlines()[:4]}


def phase_slice14(cuda_op, torch):
    """Slice 14's path: the main job (the plane on, the checks the module
    docstring lists) and the short desync/stall job; returns what
    ``report_slice14`` prints and the launches per kernel row summed over
    the workers."""
    import gc
    import glob
    import os
    import tempfile
    import threading

    from ompi_release_tpu_torch.native import build_library

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cuda_op.build()
    build_library()
    out = {}
    with tempfile.TemporaryDirectory() as td:
        dump_dir = os.path.join(td, "dumps")
        pm_dir = os.path.join(td, "pm")
        mca = [("obs_enable", "1"), ("obs_sentinel", "2"),
               ("obs_sample_interval", "0.25"), ("obs_journal_size",
                                                 str(1 << 17)),
               ("btl_nativewire_events", "1"),
               ("obs_dump_dir", dump_dir), ("obs_postmortem_dir", pm_dir)]
        # the poke thread waits for the workers' ready files, pokes
        # worker 1 with SIGUSR1 and queries tpu_ps, then lets them go
        poke = {}
        th = threading.Thread(target=s14_poke, args=(td, poke),
                              daemon=True)
        th.start()
        rc, wall, job, res = run_slice_job(14, "main", S14_PROCS, td, mca)
        th.join(timeout=5)
        check(rc == 0, f"slice 14: the main job exited {rc}")
        fleet = job.hnp.fleet_series()["procs"]
        check(sorted(fleet) == [str(p) for p in range(S14_PROCS)]
              and all(e["points"] for e in fleet.values()),
              f"slice 14: the HNP's series store {sorted(fleet)}")
        out["fleet_points"] = {p: len(e["points"]) for p, e in fleet.items()}
        out["dumps"] = s14_check_dumps(dump_dir, pm_dir, poke)
        out["dump_bytes"] = sum(os.path.getsize(p) for p in
                                glob.glob(os.path.join(dump_dir, "*")))
    out["main"] = {"wall": wall, "res": res}
    with tempfile.TemporaryDirectory() as td:
        pm_dir = os.path.join(td, "pm")
        mca = [("obs_enable", "1"), ("obs_sentinel", "2"),
               ("obs_stall_timeout", str(S14_STALL_S)),
               ("obs_postmortem_dir", pm_dir)]
        rc, wall2, _job, res2 = run_slice_job(14, "desync", S14_PROCS, td,
                                              mca)
        check(rc == 0, f"slice 14 (desync): the job exited {rc}")
        for r in res2:
            msg = r["mismatch"]
            check("ERR_COLL_MISMATCH" in msg and "process " in msg
                  and msg.count("chip_smoke.py:") == 2
                  and r["mismatch_s"] < 5.0,
                  f"slice 14 (desync): worker {r['pidx']}: {msg} after "
                  f"{r['mismatch_s']:.2f} s")
        check("process 1" in res2[0]["mismatch"]
              and "process 0" in res2[1]["mismatch"],
              "slice 14 (desync): the errors do not name the divergent "
              "process")
        stalls = []
        for path in glob.glob(os.path.join(pm_dir,
                                           "postmortem-p0-*-stall-*.json")):
            with open(path) as f:
                stalls.extend(json.load(f).get("stalled", []))
        named = [s for s in stalls if s["op"] == "allreduce"
                 and 1 in (s.get("info") or {}).get("awaiting_procs", [])
                 and set(range(S14_RANKS, S14_N)) <= set(
                     (s.get("info") or {}).get("awaiting_ranks", []))]
        check(named, f"slice 14 (desync): no stall postmortem of worker 0 "
                     f"names the allreduce and worker 1's ranks: {stalls}")
        out["desync"] = {"wall": wall2, "res": res2, "stalled": named[0]}
    sums = {name: sum(r["launches"][name] for r in res)
            for name in ("stream_axpy[sum]", "flash_fwd", "flash_bwd_dq",
                         "flash_bwd_dkv")}
    out["launches"] = sums
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 3: slice-14 path: the obs plane over the spanning job "
        f"(checks 1-7 passed); launches {sums}; the phase took "
        f"{out['seconds']:.1f} s")
    return out


def time_slice14(comm, torch, model):
    """The two overhead ratios of this process: the in-process 1 MiB
    allreduce on ``comm`` with the sentinel at 0 and at 1 (the plane on
    in both legs, bench.py:1539-1583), and the one-card TpuLM train step
    with the plane off and on; S14_TURNS interleaved turns, medians."""
    from ompi_release_tpu_torch import entry as tentry
    from ompi_release_tpu_torch import obs
    from ompi_release_tpu_torch.mca import pvar as tpvar
    from ompi_release_tpu_torch.mca import var as tmvar
    from ompi_release_tpu_torch.obs import sentinel

    dev = comm.device
    x = torch.ones((comm.size, MIB // 4), device=dev)
    hashed = tpvar.PVARS.lookup("sentinel_ops_hashed")

    def calls():
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(S14_SENTINEL_CALLS):
            comm.allreduce(x)
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) / S14_SENTINEL_CALLS * 1e3

    obs.enable()
    try:
        comm.allreduce(x)
        s0, s1 = [], []
        h0 = hashed.read()
        for _ in range(S14_TURNS):
            tmvar.set_value("obs_sentinel", 0)
            sentinel.refresh(True)
            s0.append(calls())
            tmvar.set_value("obs_sentinel", 1)
            sentinel.refresh(True)
            s1.append(calls())
        n_hashed = hashed.read() - h0
    finally:
        tmvar.VARS.unset("obs_sentinel")
        obs.disable()
        obs.journal.clear()
    check(n_hashed == S14_TURNS * S14_SENTINEL_CALLS,
          f"slice 14: the sentinel hashed {n_hashed} calls")
    tok, tgt = tentry._batch(model.cfg, tentry.EVAL_BATCH, tentry.EVAL_SEQ,
                             seed=11)
    tok = torch.as_tensor(tok, device=model.device)
    tgt = torch.as_tensor(tgt, device=model.device)

    def step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.train_step(tok, tgt)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    step()
    t_off, t_on = [], []
    try:
        for _ in range(S14_TURNS):
            obs.disable()
            t_off.append(step())
            obs.enable()
            t_on.append(step())
    finally:
        obs.disable()
        obs.journal.clear()
    med = statistics.median
    return {"sentinel0_ms": med(s0), "sentinel1_ms": med(s1),
            "sentinel_ratio": med(s1) / med(s0), "sentinel0_each": s0,
            "sentinel1_each": s1, "train_off_ms": med(t_off),
            "train_on_ms": med(t_on), "train_ratio": med(t_on) / med(t_off),
            "train_off_each": t_off, "train_on_each": t_on}


def report_slice14(s14, timing):
    """Slice 14's numbers per worker and the four overhead ratios beside
    their budgets, each beside the card's name and power limit."""
    card = card_line()
    for r in s14["main"]["res"]:
        ov = r["overheads"]
        log(json.dumps({
            "s14_worker": r["pidx"], "card": card,
            "clock_offset_s": r["clock_offset_s"],
            "clock_rtt_s": r["clock_rtt_s"],
            "launches": r["launches"], "spans_by_layer": r["spans_by_layer"],
            "journal_dropped": r["journal_dropped"],
            "records_check": r["records"],
            "tpulm": r["model"],
            "obs_on_256KiB_ms": ov["obs_on_ms"],
            "obs_off_256KiB_ms": ov["obs_off_ms"],
            "obs_ratio": ov["obs_ratio"], "obs_budget": S14_OBS_BUDGET,
            "obs_exec": ov["obs_exec"], "obs_exec_why": ov["obs_exec_why"],
            "obs_s2_on_256KiB_ms": ov["obs_s2_on_ms"],
            "obs_s2_off_256KiB_ms": ov["obs_s2_off_ms"],
            "obs_s2_ratio": ov["obs_s2_ratio"],
            "obs_s2_exec": ov["obs_s2_exec"],
            "inline_exchange_ms": ov["inline_exchange_ms"],
            "s2_fire_split": ov["split"],
            "events_on_8MiB_rtt_ms": ov["events_on_ms"],
            "events_off_8MiB_rtt_ms": ov["events_off_ms"],
            "events_ratio": ov["events_ratio"],
            "events_budget": S14_EVENTS_BUDGET,
            "phase_a_s": r["phase_a_s"], "phase_b_s": r["phase_b_s"],
            "peak_device_memory_GiB": r["peak_device_memory_GiB"],
            "seconds": r["seconds"]}))
    for r in s14["desync"]["res"]:
        log(json.dumps({"s14_desync_worker": r["pidx"], "card": card,
                        "mismatch_s": r["mismatch_s"],
                        "mismatch": r["mismatch"][:240],
                        "stall_wait_s": r["stall_wait_s"]}))
    d = s14["dumps"]
    log(json.dumps({
        "s14_doctor": True, "card": card, "merged": d["merged"],
        "native_fragment_pairs": d["native_pairs"],
        "late_round": d["late_round"], "contract_divergences":
            d["contracts"], "fleet_points": s14["fleet_points"],
        "dump_bytes": s14["dump_bytes"],
        "stalled": s14["desync"]["stalled"],
        "ps_workers": d["ps"]["workers"],
        "ps_states": d["ps"].get("proc_states"),
        "main_job_wall_s": s14["main"]["wall"],
        "desync_job_wall_s": s14["desync"]["wall"],
        "phase_s": s14["seconds"]}))
    if timing is not None:
        log(json.dumps({
            "s14_overheads": True, "card": card,
            "sentinel0_1MiB_ms": timing["sentinel0_ms"],
            "sentinel1_1MiB_ms": timing["sentinel1_ms"],
            "sentinel_ratio": timing["sentinel_ratio"],
            "tpulm_train_obs_off_ms": timing["train_off_ms"],
            "tpulm_train_obs_on_ms": timing["train_on_ms"],
            "train_ratio": timing["train_ratio"],
            "each": {k: v for k, v in timing.items()
                     if k.endswith("_each")}}))


# ---------------------------------------------------------------------------
# slice 15: the service plane (two tenants on one card), the tools
# ---------------------------------------------------------------------------

S15_PROCS = 2
S15_RANKS = 2  # virtual ranks a worker owns on cuda:0
S15_N = S15_PROCS * S15_RANKS
S15_KILL_PROCS = 3
S15_KILL_N = S15_KILL_PROCS * S15_RANKS
S15_QOS = "latency:8,bulk:2"
S15_LAT_SHARE = 8 / 10  # service.qos.fair_share("latency", ...)
S15_LAT_BYTES = 256 * 1024
S15_LAT_CALLS = 200  # calls a leg of the latency tenant
S15_LAT_WARM = 3  # record and replay before a leg's clock starts
S15_BULK_BYTES = 64 * MIB
S15_BULK_MAX = 400  # 64 MiB allreduces the bulk tenant runs at most
S15_BESIDE_MAX_S = 90.0  # the latency tenant's calls beside the kill
S15_RENEW_EVERY = 20  # latency calls between lease renewals
S15_KILL_STEP = 10  # the kill job's worker 2 dies before this call
S15_KILL_REASON = "worker 2 died mid-allreduce"
S15_WAIT_S = 180.0
S15_TUNE_SIZES = (1024, 64 * 1024, MIB, 16 * MIB)
S15_WITHDRAWN = "qos arbiter active"  # coll.native_exec's reason


def s15_rows(torch, count, off, dev):
    """This worker's rank-stacked input of slice 15 (the pattern of
    slice 10, rank ``off + i`` in row i)."""
    return torch.stack([s10_pattern(torch, count, off + i, dev)
                        for i in range(S15_RANKS)])


def s15_sum(torch, count, n, dev):
    """The closed form of the SUM of ``s10_pattern`` over ``n`` ranks,
    one row a local rank."""
    row = (torch.arange(count, device=dev) % 13 * n
           + n * (n - 1) // 2).float()
    return row.expand(S15_RANKS, count).contiguous()


def s15_flag(out_dir, name, doc=None):
    import os

    path = os.path.join(out_dir, name)
    with open(path + ".tmp", "w") as f:
        json.dump(doc or {}, f)
    os.replace(path + ".tmp", path)


def s15_wait(out_dir, *names):
    import os

    for name in names:
        s14_wait_file(os.path.join(out_dir, name), S15_WAIT_S)


def s15_attach(w, rt, torch, name, qos, pidx):
    """Admission as a tenant of the daemon at ``$OMPITPU_SERVICED``:
    worker 0 admits, the grant's tenant id reaches every worker through
    WORLD, and every worker builds the comm on the tenant band's first
    cid, stamped with its QoS class."""
    import os

    from ompi_release_tpu_torch.comm.communicator import Communicator
    from ompi_release_tpu_torch.ft import ulfm
    from ompi_release_tpu_torch.service.daemon import ServiceClient

    host, port = os.environ["OMPITPU_SERVICED"].rsplit(":", 1)
    contrib = torch.zeros((S15_RANKS, 4), dtype=torch.float32,
                          device=w.device)
    cl = grant = None
    if pidx == 0:
        cl = ServiceClient(host, int(port))
        grant = cl.admit(name, ranks=w.size, qos=qos)
        contrib[0, 0] = grant["tid"] + 1
    tid = int(w.allreduce(contrib)[0, 0]) - 1
    tc = Communicator(rt, w.group, name=f"t{tid}",
                      cid=ulfm.tenant_cid(tid, 0))
    tc.set_qos_class(qos)
    lo, hi = ulfm.tenant_band(tid)
    check(tid >= 0 and lo <= tc.cid < hi
          and ulfm.tenant_of_cid(tc.cid) == tid and tc.qos_class == qos,
          f"slice 15: {name}'s tenant comm {tc.cid} (tenant {tid}, band "
          f"[{lo}, {hi}), class {tc.qos_class})")
    return cl, grant, tid, tc


def s15_withdrawals(cid):
    """The spanning plans of ``cid`` the C executor withdrew from under
    the QoS arbiter, and every plan's executor and reason."""
    from ompi_release_tpu_torch.coll import plan as cplan

    states = {str(sig): (st.last, st.why)
              for (c, sig), st in list(cplan._span_states.items())
              if c == cid}
    return sum(1 for _last, why in states.values()
               if why and why.endswith(S15_WITHDRAWN)), states


def s15_latency(w, rt, tmvar, torch, cuda_op, dev, pidx, out_dir):
    """The latency tenant: 256 KiB allreduces on its tenant comm, alone,
    beside the bulk tenant under QoS, beside it with QoS off, then
    beside the kill job with lease renewals, and a clean release."""
    import os

    from ompi_release_tpu_torch.mca import pvar

    cl, grant, tid, tc = s15_attach(w, rt, torch, "lat-job", "latency",
                                    pidx)
    off = rt.local_rank_offset
    elems = S15_LAT_BYTES // 4
    x = s15_rows(torch, elems, off, dev)
    want = s15_sum(torch, elems, S15_N, dev)
    fallbacks = pvar.PVARS.lookup("plan_native_fallbacks")
    out = {"tid": tid, "cid": tc.cid, "legs": {}}

    def leg(name):
        for _ in range(S15_LAT_WARM):
            tc.allreduce(x)
        tc.barrier()
        ms = []
        for _ in range(S15_LAT_CALLS):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            got = tc.allreduce(x)
            torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            check(bits_equal(got, want), f"slice 15: a {name} latency "
                                         "allreduce differs from its "
                                         "closed form")
        out["legs"][name] = ms

    s15_wait(out_dir, "b-ready", "k-ready")
    cuda_op.reset_launches()
    f0 = float(fallbacks.read())
    leg("solo")
    if pidx == 0:
        s15_flag(out_dir, "lat-solo-done")
    s15_wait(out_dir, "bulk-running")
    leg("qos")
    out["withdrawn_qos"], out["plans_qos"] = s15_withdrawals(tc.cid)
    out["fallbacks_qos"] = float(fallbacks.read()) - f0
    if pidx == 0:
        s15_flag(out_dir, "lat-qos-done")
    s15_wait(out_dir, "bulk-fifo")
    tmvar.set_value("wire_qos_classes", "")  # FIFO: the arbiter is off
    tc.barrier()
    leg("fifo")
    out["withdrawn_fifo"], out["plans_fifo"] = s15_withdrawals(tc.cid)
    tmvar.set_value("wire_qos_classes", S15_QOS)
    if pidx == 0:
        s15_flag(out_dir, "lat-fifo-done")
    # beside the kill job: calls and renewals until the parent reports
    # the kill job's end (a flag all workers agree on through the comm)
    t0 = time.perf_counter()
    calls = renewals = 0
    flag = torch.zeros((S15_RANKS, 4), dtype=torch.float32, device=dev)
    while True:
        got = tc.allreduce(x)
        calls += 1
        check(bits_equal(got, want), "slice 15: a latency allreduce "
                                     "beside the kill differs")
        if pidx == 0 and calls % S15_RENEW_EVERY == 0:
            dt = time.perf_counter() - t0
            cl.renew(tid, grant["token"], stats={
                "coll_s": calls / dt,
                "mb_s": calls * S15_LAT_BYTES / dt / 1e6})
            renewals += 1
        if calls % 10 == 0:
            f = flag.clone()
            if pidx == 0:
                f[0, 0] = float(os.path.exists(
                    os.path.join(out_dir, "k-done")))
            if float(tc.allreduce(f)[0, 0]) > 0:
                break
            check(time.perf_counter() - t0 < S15_BESIDE_MAX_S,
                  "slice 15: the kill job did not end within "
                  f"{S15_BESIDE_MAX_S} s")
    out["beside_kill"] = {"calls": calls, "renewals": renewals,
                          "seconds": time.perf_counter() - t0}
    torch.cuda.synchronize(dev)
    out["launches"] = {k: cuda_op.LAUNCHES[k] for k in
                       ("sum", "flash_fwd", "flash_bwd_dq",
                        "flash_bwd_dkv")}
    tc.barrier()
    if pidx == 0:
        out["release"] = cl.release(tid, grant["token"])
        cl.close()
    tc.free()
    return out


def s15_bulk(w, rt, tmvar, torch, cuda_op, dev, pidx, out_dir):
    """The bulk tenant: 64 MiB allreduces (the SUM kernel in hier's
    fold) beside the latency tenant's legs, QoS on then off, every
    output its closed form; then the full-width TpuLM's eval and two
    AdamW steps on its tenant comm with QoS off and again on, bitwise
    equal; worker 0 checkpoints the results and releases the lease."""
    import os

    from ompi_release_tpu_torch.ft.checkpoint import Checkpointer

    cl, grant, tid, tc = s15_attach(w, rt, torch, "bulk-job", "bulk",
                                    pidx)
    off = rt.local_rank_offset
    elems = S15_BULK_BYTES // 4
    x = s15_rows(torch, elems, off, dev)
    want = s15_sum(torch, elems, S15_N, dev)
    ctrl = torch.zeros((S15_RANKS, 4), dtype=torch.float32, device=dev)
    if pidx == 0:
        s15_flag(out_dir, "b-ready")
    s15_wait(out_dir, "lat-solo-done")
    tc.barrier()
    cuda_op.reset_launches()
    ms = {"qos": [], "fifo": []}
    mode = "qos"
    last = None
    out_withdrawn = (0, {})
    for _ in range(S15_BULK_MAX):
        # worker 0 reads the latency tenant's progress; the comm agrees
        c = ctrl.clone()
        if pidx == 0:
            c[0, 0] = (2.0 if os.path.exists(os.path.join(
                out_dir, "lat-fifo-done")) else 1.0 if os.path.exists(
                os.path.join(out_dir, "lat-qos-done")) else 0.0)
        code = int(tc.allreduce(c)[0, 0])
        if code == 2:
            break
        if code == 1 and mode == "qos":
            out_withdrawn = s15_withdrawals(tc.cid)
            tmvar.set_value("wire_qos_classes", "")
            mode = "fifo"
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        last = tc.allreduce(x)
        torch.cuda.synchronize(dev)
        ms[mode].append((time.perf_counter() - t0) * 1e3)
        check(bits_equal(last, want), f"slice 15: a {mode} 64 MiB bulk "
                                      "allreduce differs from its "
                                      "closed form")
        if pidx == 0 and len(ms[mode]) == 1:
            s15_flag(out_dir, "bulk-running" if mode == "qos"
                     else "bulk-fifo")
    else:
        check(False, f"slice 15: the bulk tenant ran {S15_BULK_MAX} "
                     "allreduces without the latency tenant finishing")
    check(ms["qos"] and ms["fifo"], f"slice 15: bulk legs {ms}")
    torch.cuda.synchronize(dev)
    sum_launches = cuda_op.LAUNCHES["sum"]
    out = {"tid": tid, "cid": tc.cid, "bulk_ms": ms,
           "withdrawn_qos": out_withdrawn[0], "plans_qos": out_withdrawn[1]}
    # the model: QoS is off now; then the same run with it on
    cuda_op.reset_launches()
    m_fifo = s14_model(tc, torch, dev, 2)
    flash = {k: cuda_op.LAUNCHES[k] for k in
             ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    tmvar.set_value("wire_qos_classes", S15_QOS)
    tc.barrier()
    m_qos = s14_model(tc, torch, dev, 2)
    check(m_qos["loss"] == m_fifo["loss"] and m_qos["ck"] == m_fifo["ck"]
          and m_qos["eval_loss"] == m_fifo["eval_loss"],
          f"slice 15: the TpuLM under QoS (loss {m_qos['loss']}, checksum "
          f"{m_qos['ck']}) differs from QoS off ({m_fifo['loss']}, "
          f"{m_fifo['ck']})")
    check(all(math.isfinite(v) for v in m_qos["loss"])
          and abs(m_qos["eval_loss"] - math.log(32000)) < 1.0,
          f"slice 15: TpuLM losses {m_qos}")
    out["model"] = m_qos
    out["model_fifo_step_s"] = m_fifo["step_s"]
    out["withdrawn_model"], _ = s15_withdrawals(tc.cid)
    out["launches"] = {"sum": sum_launches, **flash}
    check(sum_launches > 0 and all(v > 0 for v in flash.values()),
          f"slice 15: bulk worker {pidx} launches {out['launches']}")
    tc.barrier()
    if pidx == 0:
        ck = Checkpointer(os.path.join(out_dir, "ckpt"))
        ck.save(2, {"allreduce": last[:1].clone(),
                    "loss": torch.tensor(m_qos["loss"],
                                         dtype=torch.float64, device=dev)},
                extra_meta={"tenant": tid})
        ck.wait()
        out["release"] = cl.release(tid, grant["token"])
        cl.close()
    tc.free()
    return out


def s15_kill(w, rt, torch, dev, pidx, out_dir):
    """The second bulk job: its worker 0 serves a tpu_server table the
    parent collects from; then worker 2 SIGKILLs itself before its
    tenant comm's 11th allreduce and the survivors see the typed error
    on the tenant-band cid; worker 0 reports the failure."""
    import os
    import signal

    from ompi_release_tpu_torch.ft import ulfm
    from ompi_release_tpu_torch.tools.tpu_server import NameServer
    from ompi_release_tpu_torch.utils.errors import ErrorCode, MPIError

    cl, grant, tid, tc = s15_attach(w, rt, torch, "bulk-kill", "bulk",
                                    pidx)
    srv = None
    if pidx == 0:
        srv = NameServer(bind_addr="127.0.0.1")
        s15_flag(out_dir, "k-server", {"port": srv.port})
    w.barrier()
    if pidx == 0:
        s15_flag(out_dir, "k-ready")
    s15_wait(out_dir, "lat-fifo-done", "collected")
    w.barrier()
    time.sleep(0.5)  # the WORLD frames land before the kill
    x = s15_rows(torch, 256, rt.local_rank_offset, dev)
    want = s15_sum(torch, 256, S15_KILL_N, dev)
    err = None
    t_kill = None
    for step in range(40):
        if pidx == 2 and step == S15_KILL_STEP:
            os.kill(os.getpid(), signal.SIGKILL)
        try:
            t_kill = time.perf_counter()
            got = tc.allreduce(x)
            check(bits_equal(got, want), "slice 15: a kill-job allreduce "
                                         "before the kill differs")
            time.sleep(0.02)
        except MPIError as e:
            err = e
            break
    check(err is not None and err.code in (ErrorCode.ERR_PROC_FAILED,
                                           ErrorCode.ERR_REVOKED),
          f"slice 15: worker {pidx} of the kill job got {err!r}")
    check(ulfm.tenant_of_cid(tc.cid) == tid, "slice 15: the failed comm "
                                             "left the tenant band")
    out = {"tid": tid, "cid": tc.cid, "error": err.code.name,
           "detect_s": time.perf_counter() - t_kill}
    if pidx == 0:
        out["fail"] = cl.fail(tid, grant["token"], reason=S15_KILL_REASON)
        cl.close()
        srv.shutdown()
    return out


def s15_worker():
    """One worker of a slice-15 job (``chip_smoke.py --slice15-worker
    MODE`` under ``tools.tpurun``; MODE is lat, bulk or kill): writes its
    results as JSON to ``$CHIP_SMOKE_S15_OUT/<mode>-worker<i>.json``."""
    import os

    import torch

    import ompi_release_tpu_torch as mpi
    from ompi_release_tpu_torch.mca import var as tmvar
    from ompi_release_tpu_torch.ops import cuda_op
    from ompi_release_tpu_torch.runtime.runtime import Runtime

    mode = sys.argv[2]
    out_dir = os.environ["CHIP_SMOKE_S15_OUT"]
    t_start = time.perf_counter()
    w = mpi.init(cli_args=["--mca", "runtime_virtual_ranks", str(S15_RANKS),
                           "--mca", "coll", "tuned,basic,self,hier"])
    rt = Runtime.current()
    pidx = int(rt.bootstrap["process_index"])
    dev = w.device
    procs = S15_KILL_PROCS if mode == "kill" else S15_PROCS
    check(w.size == procs * S15_RANKS and w.spans_processes
          and dev.type == "cuda", f"slice 15 ({mode}): WORLD {w.size} "
                                  f"ranks on {dev}")
    torch.cuda.reset_peak_memory_stats(dev)
    out = {"pidx": pidx, "pid": os.getpid(), "mode": mode}
    if mode == "lat":
        out.update(s15_latency(w, rt, tmvar, torch, cuda_op, dev, pidx,
                               out_dir))
    elif mode == "bulk":
        out.update(s15_bulk(w, rt, tmvar, torch, cuda_op, dev, pidx,
                            out_dir))
    else:
        out.update(s15_kill(w, rt, torch, dev, pidx, out_dir))
    torch.cuda.synchronize(dev)
    out["peak_device_memory_GiB"] = \
        torch.cuda.max_memory_allocated(dev) / 2 ** 30
    out["seconds"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, f"{mode}-worker{pidx}.json"), "w") as f:
        json.dump(out, f)
    mpi.finalize()
    return 0


def s15_job(mode, procs, mca, res, job_kw=None):
    """One tpurun job of slice 15 (on a thread of the parent): the
    workers run ``--slice15-worker MODE``; ``res[mode]`` gets (rc, wall
    seconds, the job) or the exception."""
    import os

    from ompi_release_tpu_torch.tools.tpurun import Job

    t0 = time.perf_counter()
    try:
        job = Job(procs, [sys.executable, os.path.abspath(__file__),
                          "--slice15-worker", mode], list(mca),
                  **(job_kw or {}))
        rc = job.run(timeout_s=S15_WAIT_S + 120)
        res[mode] = (rc, time.perf_counter() - t0, job)
    except BaseException as e:  # reported by the phase, never swallowed
        res[mode] = e


def s15_tool(fn, argv):
    """Run a tool's ``main(argv)`` in this process; returns (rc, its
    standard output)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def s15_collect(out_dir, res):
    """On a thread: once the kill job's worker 0 serves its table, fetch
    its journal with ``tpu_doctor collect`` and its pvar page with
    ``tpu_top --metrics``, then let the kill job go on."""
    import os

    from ompi_release_tpu_torch.tools import tpu_doctor, tpu_top

    try:
        s15_wait(out_dir, "k-server")
        with open(os.path.join(out_dir, "k-server")) as f:
            target = f"127.0.0.1:{json.load(f)['port']}"
        dump_dir = os.path.join(out_dir, "collect-dump")
        res["collect"] = s15_tool(tpu_doctor.main, [
            "collect", target, "-o", dump_dir, "--metrics"])
        with open(os.path.join(dump_dir, "journal-p0.json")) as f:
            res["journal"] = json.load(f)
        res["metrics"] = s15_tool(tpu_top.main, [
            "--metrics", target, "--iterations", "1"])
    except BaseException as e:
        res["error"] = repr(e)
    finally:
        s15_flag(out_dir, "collected")


def s15_leftovers(job, label):
    import glob
    import os

    check(all(p.poll() is not None for p in job.procs.values()),
          f"slice 15 ({label}): a worker outlived its job")
    leftovers = [f for pid in job._local_pids
                 for pat in (f"ompitpu-{pid}-*", f"onw-{pid:x}-*",
                             f"onwev-{pid:x}-*")
                 for f in glob.glob(os.path.join("/dev/shm", pat))]
    check(not leftovers, f"slice 15 ({label}): shm segments or rings "
                         f"left {leftovers}")


def phase_slice15(cuda_op, torch):
    """Slice 15's path: one ``tpu-serviced`` daemon (a child process), a
    latency tenant and a bulk tenant (2 workers x 2 virtual ranks each,
    ``wire_qos_classes`` latency:8,bulk:2) and a second bulk job whose
    worker 2 dies; then the tools against what they left. Returns what
    ``report_slice15`` prints and the launches per kernel row."""
    import gc
    import os
    import secrets
    import signal
    import subprocess as sp
    import tempfile
    import threading

    from ompi_release_tpu_torch.native import build_library
    from ompi_release_tpu_torch.tools import (tpu_checkpoint, tpu_clean,
                                              tpu_info, tpu_top)

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cuda_op.build()
    build_library()
    out = {}
    env_keep = dict(os.environ)
    daemon = sp.Popen([sys.executable, "-m",
                       "ompi_release_tpu_torch.service.daemon", "--bind",
                       "127.0.0.1", "--lease", "60"],
                      cwd=os.path.dirname(os.path.abspath(__file__)),
                      stdout=sp.PIPE, text=True)
    try:
        line = daemon.stdout.readline()
        check(line.startswith("tpu-serviced URI: "),
              f"slice 15: the daemon printed {line!r}")
        target = line.split()[-1]
        with tempfile.TemporaryDirectory() as td:
            os.environ["OMPITPU_SERVICED"] = target
            os.environ["CHIP_SMOKE_S15_OUT"] = td
            # one control-plane secret for the three jobs: each Job
            # reads it from the environment, and jobs built on threads
            # at once must not each publish their own
            os.environ["OMPITPU_JOB_SECRET"] = secrets.token_hex(16)
            mca = [("wire_qos_classes", S15_QOS)]
            res, coll = {}, {}
            kill_kw = {"on_failure": "continue", "heartbeat_s": 0.3,
                       "miss_limit": 3}
            threads = [threading.Thread(target=s15_job, args=a,
                                        daemon=True) for a in (
                ("lat", S15_PROCS, mca, res, {"heartbeat_s": 0.5,
                                              "miss_limit": 20}),
                ("bulk", S15_PROCS, mca, res, {"heartbeat_s": 0.5,
                                               "miss_limit": 20}),
                ("kill", S15_KILL_PROCS, mca + [("obs_enable", "1")], res,
                 kill_kw))]
            threads.append(threading.Thread(target=s15_collect,
                                            args=(td, coll), daemon=True))
            for th in threads:
                th.start()
            threads[2].join(timeout=S15_WAIT_S + 180)
            s15_flag(td, "k-done")
            for th in threads:
                th.join(timeout=S15_WAIT_S + 180)
            check(not any(th.is_alive() for th in threads),
                  "slice 15: a job outlived its time")
            check("error" not in coll, f"slice 15: the collect: {coll}")
            for mode in ("lat", "bulk", "kill"):
                r = res.get(mode)
                check(isinstance(r, tuple), f"slice 15 ({mode}): {r!r}")
                check(r[0] == 0, f"slice 15 ({mode}): the job exited "
                                 f"{r[0]}")
                s15_leftovers(r[2], mode)
            check(r[2]._ft_failed_ranks, "slice 15: the kill job promoted "
                                         "no dead worker")
            rs = {}
            for mode, procs in (("lat", S15_PROCS), ("bulk", S15_PROCS),
                                ("kill", S15_KILL_PROCS)):
                rs[mode] = []
                for p in range(procs):
                    path = os.path.join(td, f"{mode}-worker{p}.json")
                    if os.path.exists(path):
                        with open(path) as f:
                            rs[mode].append(json.load(f))
            check(len(rs["lat"]) == S15_PROCS and len(rs["bulk"])
                  == S15_PROCS and [r["pidx"] for r in rs["kill"]]
                  == [0, 1], f"slice 15: results "
                             f"{ {m: len(v) for m, v in rs.items()} }")
            out["res"] = rs
            out["walls"] = {m: res[m][1] for m in res}
            # the tools against what the jobs left
            rc, text = s15_tool(tpu_top.main, ["--tenants", target,
                                               "--iterations", "1"])
            check(rc == 0 and S15_KILL_REASON in text
                  and "released" in text and "(no live tenants)" in text,
                  f"slice 15: tpu_top --tenants rc {rc}:\n{text}")
            out["tenants_frame"] = text
            rc, text = s15_tool(tpu_clean.main, ["--dry-run"])
            check(rc == 0 and "would remove" in text,
                  f"slice 15: tpu_clean rc {rc}: {text}")
            out["clean"] = text.strip()
            rc, text = s15_tool(tpu_checkpoint.main,
                                ["verify", os.path.join(td, "ckpt")])
            check(rc == 0 and "verified OK" in text,
                  f"slice 15: tpu_checkpoint verify rc {rc}: {text}")
            out["checkpoint"] = text.strip()
            out["collect"] = coll
    finally:
        os.environ.clear()
        os.environ.update(env_keep)
        daemon.send_signal(signal.SIGINT)
        try:
            daemon.wait(timeout=10)
        except sp.TimeoutExpired:
            daemon.kill()
            daemon.wait()
    check(daemon.returncode == 0, f"slice 15: the daemon exited "
                                  f"{daemon.returncode}")
    rc, text = s15_tool(tpu_info.main, ["--json"])
    info = json.loads(text)
    check(rc == 0 and info["devices"][0]["kind"]
          == torch.cuda.get_device_name(0)
          and info["devices"][0]["platform"] == "gpu",
          f"slice 15: tpu_info --json devices {info['devices']}")
    out["info_devices"] = info["devices"]
    coll = out["collect"]
    check(coll["collect"][0] == 0 and coll["journal"].get("spans")
          and coll["metrics"][0] == 0
          and "wire_" in coll["metrics"][1],
          f"slice 15: tpu_doctor collect / tpu_top --metrics: "
          f"{coll['collect']} {str(coll['metrics'])[:400]}")
    sums = {name: sum(r["launches"][key] for m in ("lat", "bulk")
                      for r in out["res"][m])
            for name, key in (("stream_axpy[sum]", "sum"),
                              ("flash_fwd", "flash_fwd"),
                              ("flash_bwd_dq", "flash_bwd_dq"),
                              ("flash_bwd_dkv", "flash_bwd_dkv"))}
    out["launches"] = sums
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 3: slice-15 path: two tenants and a failed one on one "
        f"daemon, the tools; launches {sums}; the phase took "
        f"{out['seconds']:.1f} s")
    return out


def s15_tune(torch):
    """``tpu_tune`` in this process on 8 virtual ranks of the card; the
    rule file it wrote is loaded through ``coll_tuned_use_dynamic_rules``
    and an allreduce at each swept size is bitwise its closed form.
    Returns the winners, the rule text and the SUM launches of the
    checked allreduces."""
    import os
    import tempfile

    import ompi_release_tpu_torch as mpi
    from ompi_release_tpu_torch.coll import dynamic_rules
    from ompi_release_tpu_torch.mca import var as tmvar
    from ompi_release_tpu_torch.ops import cuda_op
    from ompi_release_tpu_torch.tools import tpu_tune

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "rules.conf")
        rc, text = s15_tool(tpu_tune.main, [
            "-o", path, "--ops", "allreduce", "--sizes",
            ",".join(str(s) for s in S15_TUNE_SIZES), "--repeats", "3",
            "--ranks", str(N_RANKS)])
        check(rc == 0 and "tpu-tune: wrote" in text,
              f"slice 15: tpu_tune rc {rc}: {text}")
        with open(path) as f:
            rules = f.read()
        tune_s = time.perf_counter() - t0
        world = mpi.init(cli_args=["--mca", "runtime_virtual_ranks",
                                   str(N_RANKS)])
        dev = world.device
        check(world.size == N_RANKS and dev.type == "cuda",
              f"slice 15: tpu_tune's WORLD {world.size} on {dev}")
        tmvar.set_value("coll", "tuned")
        try:
            tuned = world.dup(name="s15_tuned")
        finally:
            tmvar.VARS.unset("coll")
        tmvar.set_value("coll_tuned_use_dynamic_rules", True)
        tmvar.set_value("coll_tuned_dynamic_rules_filename", path)
        try:
            check(dynamic_rules.load_rules(path), "slice 15: the emitted "
                                                  "rule file holds no rule")
            cuda_op.reset_launches()
            for size in S15_TUNE_SIZES:
                elems = size // 4
                x = torch.stack([s10_pattern(torch, elems, r, dev)
                                 for r in range(N_RANKS)])
                want = (torch.arange(elems, device=dev) % 13 * N_RANKS
                        + N_RANKS * (N_RANKS - 1) // 2).float().expand(
                    N_RANKS, elems)
                check(bits_equal(tuned.allreduce(x), want.contiguous()),
                      f"slice 15: the {size} B allreduce under the tuned "
                      "rules differs from its closed form")
            torch.cuda.synchronize(dev)
            sums = cuda_op.LAUNCHES["sum"]
        finally:
            tmvar.VARS.unset("coll_tuned_use_dynamic_rules")
            tmvar.VARS.unset("coll_tuned_dynamic_rules_filename")
            tuned.free()
    winners = [ln.split() for ln in rules.splitlines()
               if ln.startswith("allreduce ")]
    check(winners, f"slice 15: no allreduce rule in\n{rules}")
    timings = [ln for ln in rules.splitlines()
               if ln.startswith("# allreduce @")]
    out = {"winners": [(int(w[2]), w[3]) for w in winners],
           "timings": timings, "tune_s": tune_s, "sum": sums,
           "seconds": time.perf_counter() - t0}
    log(f"slice 15: tpu_tune on {N_RANKS} virtual ranks "
        f"({tune_s:.1f} s): rules {out['winners']}; every swept size "
        f"bitwise its closed form under them; stream_axpy[sum] {sums}")
    for ln in timings:
        log(f"slice 15:   {ln[2:]}")
    return out


def s15_p(ms, q):
    import statistics

    if q == 50:
        return statistics.median(ms)
    return statistics.quantiles(ms, n=100, method="inclusive")[q - 1]


def report_slice15(s15):
    """Print slice 15's numbers: the latency tenant's p50/p99 a leg and
    the isolation and FIFO ratios beside the simulator's bound, the bulk
    tenant's allreduce ms and bus GB/s, the TpuLM step inside a tenant,
    the C executor's withdrawals, the kill episode and the tools."""
    card = card_line()
    res = s15["res"]
    for mode in ("lat", "bulk", "kill"):
        for r in res[mode]:
            log(f"slice 15: {mode} worker {r['pidx']} launches "
                f"{r.get('launches')} peak "
                f"{r['peak_device_memory_GiB']:.2f} GiB, {r['seconds']:.1f} s")
    legs = {}
    for r in res["lat"]:
        for name, ms in r["legs"].items():
            legs.setdefault(name, []).extend(ms)
    p = {name: (s15_p(ms, 50), s15_p(ms, 99)) for name, ms in legs.items()}
    iso = p["qos"][1] / p["solo"][1]
    fifo = p["fifo"][1] / p["solo"][1]
    for name in ("solo", "qos", "fifo"):
        log(f"slice 15: latency tenant {name}: {S15_LAT_CALLS} x "
            f"{S15_LAT_BYTES >> 10} KiB allreduces a worker, p50 "
            f"{p[name][0]:.4f} ms, p99 {p[name][1]:.4f} ms")
    log(f"slice 15: isolation ratio (QoS p99 / solo p99) {iso:.4f} beside "
        f"the simulator's bound 1/fair_share = {1 / S15_LAT_SHARE:.2f}; "
        f"FIFO ratio {fifo:.4f} [{card}]")
    for r in res["lat"]:
        log(f"slice 15: latency worker {r['pidx']}: C-executor withdrawals "
            f"under the arbiter {r['withdrawn_qos']} of "
            f"{len(r['plans_qos'])} plans (plan_native_fallbacks "
            f"+{r['fallbacks_qos']:.0f}); QoS off: {r['plans_fifo']}; "
            f"beside the kill {r['beside_kill']}")
    n = S15_N
    for r in res["bulk"]:
        for mode, ms in r["bulk_ms"].items():
            med = s15_p(ms[1:] or ms, 50)
            bus = 2 * (n - 1) / n * S15_BULK_BYTES / (med / 1e3) / 1e9
            log(f"slice 15: bulk worker {r['pidx']} {mode}: "
                f"{len(ms)} x 64 MiB allreduces, median {med:.2f} ms, bus "
                f"{bus:.3f} GB/s [{card}]")
        m = r["model"]
        log(f"slice 15: bulk worker {r['pidx']}: TpuLM in a tenant, eval "
            f"loss {m['eval_loss']:.4f}, losses {m['loss']}, step ms "
            f"{[round(s * 1e3, 1) for s in m['step_s']]} (QoS off "
            f"{[round(s * 1e3, 1) for s in r['model_fifo_step_s']]}), "
            f"bitwise QoS on == off; C-executor withdrawals under the "
            f"arbiter {r['withdrawn_qos']} (bulk loop), "
            f"{r['withdrawn_model']} (model) [{card}]")
    for r in res["kill"]:
        log(f"slice 15: kill job worker {r['pidx']}: {r['error']} on "
            f"tenant cid {r['cid']} after {r['detect_s']:.3f} s")
    log("slice 15: tpu_top --tenants:\n" + s15["tenants_frame"])
    log(f"slice 15: {s15['clean']}; {s15['checkpoint']}")
    coll = s15["collect"]
    log(f"slice 15: tpu_doctor collect: {coll['collect'][1].strip()}; "
        f"tpu_top --metrics: {len(coll['metrics'][1].splitlines())} lines")
    log(f"slice 15: tpu_info devices {s15['info_devices']}")
    log(f"slice 15: walls {s15['walls']}; the phase "
        f"{s15['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# slice 16: the distributed bootstrap — processes of this script started by
# hand, no launcher — and bench.py's native_wire QoS leg
# ---------------------------------------------------------------------------

S16_PROCS = 2
S16_RANKS = 4  # virtual ranks a process owns on cuda:0
#: per-rank f32 allreduce sizes (bytes)
S16_SIZES = (8, 256 * 1024, 16 * MIB, 256 * MIB)
S16_REPS = 5  # timed replays a size (median)


def s16_env(port, pid, secret, extra=None):
    """A hand-started process's environment: the three variables of the
    distributed bootstrap, one job secret for both, and no launcher
    variable inherited from an earlier phase."""
    import os

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("OMPITPU_", "CHIP_SMOKE_S"))}
    env.update({"OMPITPU_COORDINATOR": f"127.0.0.1:{port}",
                "OMPITPU_PROCESS_ID": str(pid),
                "OMPITPU_NUM_PROCESSES": str(S16_PROCS),
                "OMPITPU_JOB_SECRET": secret, **(extra or {})})
    return env


def s16_pair(argv, extra, label, timeout_s=300):
    """Start ``S16_PROCS`` processes of ``argv`` by hand (ids 0 and 1,
    a free port on 127.0.0.1), wait for both within ``timeout_s`` and
    fail unless each exits 0 and none leaves a shm segment, a
    nativewire ring or an event ring of its pid. Returns [(stdout,
    pid)] by process id and the wall seconds."""
    import glob
    import os
    import secrets
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    secret = secrets.token_hex(16)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(argv, env=s16_env(port, pid, secret, extra),
                              cwd=os.path.dirname(os.path.abspath(__file__)),
                              stdout=subprocess.PIPE, text=True)
             for pid in range(S16_PROCS)]
    outs = []
    try:
        for p in procs:
            left = timeout_s - (time.perf_counter() - t0)
            outs.append(p.communicate(timeout=max(1.0, left))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for pid, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0,
              f"slice 16 ({label}): process {pid} exited {p.returncode}: "
              f"{out[-2000:]}")
    leftovers = [f for p in procs
                 for pat in (f"ompitpu-{p.pid}-*", f"onw-{p.pid:x}-*",
                             f"onwev-{p.pid:x}-*")
                 for f in glob.glob(os.path.join("/dev/shm", pat))]
    check(not leftovers, f"slice 16 ({label}): shm segments or rings "
                         f"left {leftovers}")
    return [(out, p.pid) for out, p in zip(outs, procs)], wall


def s16_worker():
    """One process of slice 16 (``chip_smoke.py --slice16-worker``),
    started by hand with the distributed bootstrap's variables (or, for
    ``--slice16-ab``, by ``tools.tpurun``): 4 virtual ranks on cuda:0 in
    an 8-rank WORLD over two processes; the f32 allreduce at each of
    ``S16_SIZES`` bitwise its closed form (slice 10's ``s10_sum``) and
    then timed, the SUM kernel's launches counted around the calls.
    Prints one ``S16 {json}`` line (and writes it to
    ``$CHIP_SMOKE_S16_OUT/worker<process index>.json`` when set)."""
    import os

    t_proc = s13_process_start()
    import torch

    import ompi_release_tpu_torch as mpi
    from ompi_release_tpu_torch.ops import cuda_op
    from ompi_release_tpu_torch.runtime import ess as ess_mod
    from ompi_release_tpu_torch.runtime.runtime import Runtime

    ess_name = ess_mod.ESS_FRAMEWORK.select().NAME
    check(ess_name == ("tpurun" if os.environ.get("OMPITPU_HNP")
                       else "distributed"),
          f"slice 16: the ESS framework selected {ess_name}")
    t0 = time.time()
    w = mpi.init(cli_args=["--mca", "runtime_virtual_ranks",
                           str(S16_RANKS)])
    t_world = time.time()
    rt = Runtime.current()
    pidx = int(rt.bootstrap["process_index"])
    off = rt.local_rank_offset
    dev = w.device
    check(w.size == S10_N and w.spans_processes and dev.type == "cuda"
          and rt.bootstrap["process_count"] == S16_PROCS
          and pidx == int(os.environ.get("OMPITPU_PROCESS_ID", pidx))
          and (off, rt.local_size) == (pidx * S16_RANKS, S16_RANKS)
          and sorted({e.process_index for e in rt.endpoints}) == [0, 1],
          f"slice 16: WORLD {w.size} ranks on {dev}, process {pidx}, "
          f"span ({off}, {rt.local_size})")
    check(w._coll_providers["allreduce"] == ["hier"],
          f"slice 16: allreduce providers {w._coll_providers}")
    check(rt.wire._nw is not None and rt.wire._btl_for(1 - pidx)
          is rt.wire._nw, "slice 16: the peer does not ride nativewire")
    out = {"pidx": pidx, "pid": os.getpid(), "ess": ess_name,
           "start_to_world_s": t_world - t_proc,
           "init_s": t_world - t0, "allreduce": {}}
    cuda_op.reset_launches()
    for nbytes in S16_SIZES:
        count = max(1, nbytes // 4)
        x = s10_rows(torch, count, off, dev)
        want = s10_sum(torch, count, dev).expand(S10_RANKS, count)
        n0 = cuda_op.LAUNCHES["sum"]
        got = w.allreduce(x)  # records the wire plan
        check(bits_equal(got, want.contiguous()),
              f"slice 16: the {nbytes} B allreduce differs from its "
              "closed form")
        ts = []
        for _ in range(S16_REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = w.allreduce(x)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
        check(bits_equal(got, want.contiguous()),
              f"slice 16: the replayed {nbytes} B allreduce differs")
        ms = statistics.median(ts) * 1e3
        out["allreduce"][nbytes] = {
            "ms": ms, "bus_GBps": 2 * (S10_N - 1) / S10_N * nbytes
            / (ms * 1e-3) / 1e9,
            "sum_launches": cuda_op.LAUNCHES["sum"] - n0}
        del x, got, want
    torch.cuda.synchronize()
    out["sum_launches"] = cuda_op.LAUNCHES["sum"]
    for nbytes in S16_SIZES:
        if nbytes >= 4 * MIB:
            check(out["allreduce"][nbytes]["sum_launches"] > 0,
                  f"slice 16: stream_axpy[sum] did not launch in the "
                  f"{nbytes} B allreduce")
    out["peak_device_memory_GiB"] = \
        torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print("S16 " + json.dumps(out), flush=True)
    if os.environ.get("CHIP_SMOKE_S16_OUT"):
        with open(os.path.join(os.environ["CHIP_SMOKE_S16_OUT"],
                               f"worker{pidx}.json"), "w") as f:
            json.dump(out, f)
    mpi.finalize()
    return 0


def s16_ab(cuda_op, torch):
    """Slice 16's workers in turns started by hand (distributed) and by
    ``tools.tpurun`` (the same worker code, so the same timing method):
    distributed, tpurun, tpurun, distributed. Prints each size's ms per
    process per run, beside the card's name and power limit."""
    import os
    import tempfile

    from ompi_release_tpu_torch.native import build_library

    cuda_op.build()
    build_library()
    card = card_line()
    runs = []
    for ess in ("distributed", "tpurun", "tpurun", "distributed"):
        if ess == "distributed":
            outs, wall = s16_pair([sys.executable, os.path.abspath(__file__),
                                   "--slice16-worker"], None, "ab")
            res = [json.loads(next(ln for ln in out.splitlines()
                                   if ln.startswith("S16 "))[4:])
                   for out, _ in outs]
        else:
            with tempfile.TemporaryDirectory() as td:
                rc, wall, _, res = run_slice_job(16, "ab", S16_PROCS, td,
                                                 timeout_s=300)
            check(rc == 0, f"slice 16 (ab): the tpurun job exited {rc}")
        check([r["ess"] for r in res] == [ess] * S16_PROCS,
              f"slice 16 (ab): selected {[r['ess'] for r in res]}")
        runs.append((ess, wall, res))
    for nbytes in S16_SIZES:
        log(json.dumps({
            "s16_ab_bytes_per_rank": nbytes, "card": card,
            "ms_by_run": [{"ess": ess, "ms": [r["allreduce"][str(nbytes)]
                                              ["ms"] for r in res]}
                          for ess, _, res in runs]}))
    log(json.dumps({
        "s16_ab_start_to_world_s": [
            {"ess": ess, "s": [r["start_to_world_s"] for r in res]}
            for ess, _, res in runs],
        "wall_s": [wall for _, wall, _ in runs], "card": card}))


def phase_slice16(cuda_op, torch):
    """Slice 16's path: the builds, then the ``unified_world_tpu``
    example in two processes started by hand (both of its result lines),
    then two processes of this script (``--slice16-worker``), then
    bench.py's native_wire QoS leg (``bench.native_wire_qos_leg``, a
    2-worker tpurun job). Every process exits 0 and leaves no ring or
    segment. Returns the workers' results, the QoS lines and the SUM
    launches summed over the workers."""
    import gc
    import os

    from ompi_release_tpu_torch.native import build_library

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cuda_op.build()
    build_library()
    outs, wall_uw = s16_pair(
        [sys.executable, "-m", "ompi_release_tpu_torch.examples."
         "unified_world_tpu"], None, "unified_world_tpu")
    for pid, (out, _) in enumerate(outs):
        lo = pid * S16_RANKS
        want = f"unified world OK (ranks {lo}..{lo + S16_RANKS - 1} of 8)"
        check(want in out, f"slice 16: process {pid} of unified_world_tpu "
                           f"printed {out[-500:]!r}")
    outs, wall = s16_pair([sys.executable, os.path.abspath(__file__),
                           "--slice16-worker"], None, "workers")
    res = []
    for out, _ in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("S16 ")]
        check(len(lines) == 1, f"slice 16: a worker printed {out[-500:]!r}")
        res.append(json.loads(lines[0][4:]))
    check([r["pidx"] for r in res] == list(range(S16_PROCS)),
          f"slice 16: process indices {[r['pidx'] for r in res]}")
    sums = [r["sum_launches"] for r in res]
    check(all(n > 0 for n in sums),
          f"slice 16: stream_axpy[sum] launches per process {sums}")
    t_qos = time.perf_counter()
    qos = tbench.native_wire_qos_leg(torch.device("cuda", 0))
    names = [ln["metric"] for ln in qos]
    check(names == ["wire_native_qos_latency_solo_s",
                    "wire_native_qos_latency_under_bulk_s"]
          and all(ln["unit"] == "s" and ln["value"] > 0
                  and ln["qos_classes"] == "latency:3,bulk:1" for ln in qos),
          f"slice 16: the QoS leg's lines {qos}")
    wall_qos = time.perf_counter() - t_qos
    log(f"phase 3: slice-16 path: unified_world_tpu and an 8-rank WORLD "
        f"over {S16_PROCS} hand-started processes (distributed ESS, no "
        f"launcher), every allreduce bitwise its closed form; "
        f"stream_axpy[sum] launches {sums}; the QoS leg; no ring or "
        f"segment left; the phase took {time.perf_counter() - t0:.1f} s")
    return {"res": res, "qos": qos, "sum": sum(sums), "wall": wall,
            "wall_example": wall_uw, "wall_qos": wall_qos}


def report_slice16(s16, s10=None):
    """Slice 16's numbers, each beside the card's name and power limit:
    per process its seconds from process start to WORLD and the
    allreduce per size beside, when slice 10 ran in this run, its
    tpurun job's replayed and interpreted ms at the same size or the
    two sizes around it; the QoS leg's two lines."""
    card = card_line()
    s10_rows_by = {}
    for r in (s10 or {}).get("res", []):
        s10_rows_by[r["pidx"]] = {int(k): v for k, v in
                                  r["s11"]["timings"]["allreduce"].items()}
    for r in s16["res"]:
        mine = s10_rows_by.get(r["pidx"], {})
        for nbytes, row in r["allreduce"].items():
            nbytes = int(nbytes)
            near = sorted(mine, key=lambda k: abs(math.log(k / nbytes)))[:2]
            log(json.dumps({
                "s16_allreduce_bytes_per_rank": nbytes,
                "worker": r["pidx"], **row,
                "s10_tpurun": {str(k): {leg: mine[k][leg]["ms"] for leg in
                                        ("replayed", "interpreted")}
                               for k in sorted(near)
                               if k == nbytes or nbytes not in mine},
                "card": card}))
        log(json.dumps({
            "s16_worker": r["pidx"], "card": card,
            "start_to_world_s": r["start_to_world_s"],
            "init_s": r["init_s"],
            "stream_axpy_sum_launches": r["sum_launches"],
            "peak_device_memory_GiB": r["peak_device_memory_GiB"]}))
    for ln in s16["qos"]:
        log(json.dumps({**ln, "card": card}))
    log(json.dumps({"s16_workers_wall_s": s16["wall"],
                    "s16_example_wall_s": s16["wall_example"],
                    "s16_qos_wall_s": s16["wall_qos"], "card": card}))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import ompi_release_tpu_torch as mpi
    from ompi_release_tpu_torch.mca import var as tmvar
    from ompi_release_tpu_torch.ops import cuda_op
    from ompi_release_tpu_torch.ops import flash_attention as fa

    # f32 products in full f32 (the plain twins, the f32 loss check)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if sys.argv[1:] == ["--slice10-worker"]:
        return s10_worker()
    if sys.argv[1:] == ["--slice12-child"]:
        return s12_child()
    if sys.argv[1:] == ["--slice13-worker"]:
        return s13_worker()
    if sys.argv[1:] == ["--slice14-worker"]:
        return s14_worker()
    if sys.argv[1:2] == ["--slice15-worker"]:
        return s15_worker()
    if sys.argv[1:] == ["--slice16-worker"]:
        return s16_worker()
    t_start = time.perf_counter()
    log(f"card: {card_line()}")
    if sys.argv[1:] == ["--slice16-ab"]:
        # slice 16's workers in turns, by hand and under tpurun; no
        # result line
        s16_ab(cuda_op, torch)
        log(f"chip_smoke --slice16-ab: passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] == ["--slice16"]:
        # slice 16 alone: the builds, the example's and the workers'
        # hand-started processes and the QoS leg; it prints no result
        # line
        report_slice16(phase_slice16(cuda_op, torch))
        log(f"chip_smoke --slice16: passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] == ["--slice15"]:
        # slice 15 alone: the builds, its jobs, the tools and tpu_tune;
        # it prints no result line
        s15 = phase_slice15(cuda_op, torch)
        s15["tune"] = s15_tune(torch)
        report_slice15(s15)
        mpi.finalize()
        log(f"chip_smoke --slice15: passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] == ["--slice14"]:
        # slice 14 alone: the builds, its two jobs, this process's two
        # overhead ratios (8 virtual ranks, the one-card TpuLM) and the
        # numbers; it prints no result line
        s14 = phase_slice14(cuda_op, torch)
        from ompi_release_tpu_torch.models.transformer import (
            ModelConfig, TpuLM)

        world = mpi.init(cli_args=["--mca", "runtime_virtual_ranks",
                                   str(N_RANKS)])
        tuned = comm_with(world, tmvar, "tuned")
        timing = time_slice14(tuned, torch, TpuLM(ModelConfig(), seed=0))
        tuned.free()
        mpi.finalize()
        report_slice14(s14, timing)
        log(f"chip_smoke --slice14: passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] == ["--slice13"]:
        # slice 13 alone: the builds, its three jobs and their numbers;
        # it prints no result line
        report_slice13(phase_slice13(cuda_op, torch))
        log(f"chip_smoke --slice13: passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] == ["--slice12"]:
        # slice 12 alone: the builds, its job and its numbers; it prints
        # no result line
        report_slice12(phase_slice12(cuda_op, torch))
        log(f"chip_smoke --slice12: passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] in (["--slice10"], ["--slice11"]):
        # slices 10 and 11 alone (--slice10) or slice 11 alone
        # (--slice11): the builds, the two jobs and their timings; it
        # prints no result line
        mode = "main" if sys.argv[1] == "--slice10" else "s11"
        report_slice10(phase_slice10(cuda_op, torch, mode))
        log(f"chip_smoke {sys.argv[1]}: passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] == ["--ring-fold"]:
        # the ring kernel alone: the build, its checks, its row of the
        # kernel table and its host cost; no result line
        cuda_op.build()
        check_ring_fold(cuda_op, torch, dev)
        row = time_ring_fold(cuda_op, torch, dev, None)
        row["host_us_per_launch"] = ring_fold_host_us(cuda_op, torch, dev)
        log(json.dumps({"ring_fold": row}))
        log(f"chip_smoke --ring-fold: passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] == ["--slice9"]:
        # a short run of slice 9 alone (the build, its phase and its
        # timings); it prints no result line
        cuda_op.build()
        phase_slice9(tmvar, cuda_op, torch, dev)
        time_slice9(torch)
        log(f"chip_smoke --slice9: passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32 matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    so = cuda_op.build()
    log(f"phase 1: built {so} in {time.perf_counter() - t0:.2f} s "
        f"from {len(cuda_op.sources())} sources")
    ptxas_report(cuda_op, so)
    hgmma = sass_report(cuda_op, so)

    phase_kernels(cuda_op, torch, dev)
    check_ring_fold(cuda_op, torch, dev)
    phase_flash(fa, torch, dev)
    phase_flash_bwd(fa, torch, dev)
    check_bf16_reduction(torch, dev)
    # slice 10 runs while this process holds little on the card: its two
    # worker processes share it (their timings print beside slice 1's)
    s10 = phase_slice10(cuda_op, torch)
    s12 = phase_slice12(cuda_op, torch)
    s13 = phase_slice13(cuda_op, torch)
    s14 = phase_slice14(cuda_op, torch)
    s15 = phase_slice15(cuda_op, torch)
    s16 = phase_slice16(cuda_op, torch)

    cuda_op.reset_launches()
    world, tuned, runs = drive_main_path(mpi, tmvar, torch, dev)
    bench = drive_bench_loops(cuda_op, torch, dev)
    torch.cuda.synchronize()
    launches = {name: cuda_op.LAUNCHES[name] for name in KERNELS}
    launches["ring_fold"] = cuda_op.LAUNCHES["ring_fold"]
    log(f"phase 3: main-path launches {launches}")
    for name, count in launches.items():
        check(count > 0, f"kernel wrapper {name} launched no time on the "
                         "main path")
    check_main_path(tmvar, torch, runs, bench)
    del runs, bench
    torch.cuda.empty_cache()

    slice6 = phase_slice6(world, tuned, tmvar, cuda_op, torch, dev)
    sum_by_path = {"slice1": launches["sum"],
                   "slice6": slice6["sum_launches"]}
    launches["sum"] += slice6["sum_launches"]
    time_slice6(slice6, tuned, world, torch, dev)
    del slice6
    torch.cuda.empty_cache()

    sum_by_path["slice7"] = phase_slice7(world, tuned, tmvar, cuda_op,
                                         torch, dev)
    launches["sum"] += sum_by_path["slice7"]
    time_slice7(tuned, torch, dev)
    torch.cuda.empty_cache()

    sum_by_path["slice8"] = phase_slice8(world, tmvar, cuda_op, torch, dev)
    launches["sum"] += sum_by_path["slice8"]
    time_slice8(world, tmvar, torch, dev)
    torch.cuda.empty_cache()

    cuda_op.reset_launches()
    p2p = drive_p2p_path(world, cuda_op, torch, dev)
    torch.cuda.synchronize()
    launches_p2p = dict(cuda_op.LAUNCHES)
    log(f"phase 3: slice-2 path launches {launches_p2p}")
    for name in ("transpose", "chain"):
        check(launches_p2p[name] > 0, f"kernel wrapper {name} launched no "
                                      "time on the main path")
        launches[name] = launches_p2p[name]
    check_p2p_path(torch, p2p)
    del p2p
    torch.cuda.empty_cache()

    cuda_op.reset_launches()
    model, evals = drive_model_path()
    torch.cuda.synchronize()
    launches_model = dict(cuda_op.LAUNCHES)
    log(f"phase 3: slice-3 path launches {launches_model}")
    launches["flash_fwd"] = launches_model["flash_fwd"]
    check_model_path(torch, model, evals, launches["flash_fwd"])
    torch.cuda.empty_cache()

    cuda_op.reset_launches()
    train_model, steps = drive_train_path()
    torch.cuda.synchronize()
    launches_train = dict(cuda_op.LAUNCHES)
    log(f"phase 3: slice-4 path launches {launches_train}")
    check_train_path(torch, train_model, steps, launches_train)
    s8_checkpoint(train_model, torch)
    torch.cuda.empty_cache()

    cuda_op.reset_launches()
    moe_model, moe_evals, moe_steps = drive_moe_path()
    torch.cuda.synchronize()
    launches_moe = dict(cuda_op.LAUNCHES)
    log(f"phase 3: slice-5 MoE path launches {launches_moe}")
    check_moe_path(torch, moe_model, moe_evals, moe_steps, launches_moe)
    torch.cuda.empty_cache()
    # the flash kernels run on every model path: each row counts them all
    by_path = {name: {"eval": launches_model[name],
                      "train": launches_train[name],
                      "moe": launches_moe[name]}
               for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    for name, counts in by_path.items():
        launches[name] = sum(counts.values())
    check_moe_layer(torch, dev)
    check_moe_tiny_vs_cpu(torch, dev)
    check_mixer_vs_cpu(torch, dev)
    torch.cuda.empty_cache()

    rows = time_kernels(cuda_op, torch, dev, launches)
    rows.append(time_ring_fold(cuda_op, torch, dev, launches["ring_fold"]))
    rows.append(time_flash(fa, torch, dev, launches["flash_fwd"], hgmma))
    rows.extend(time_flash_bwd(fa, torch, dev, launches, hgmma))
    for row in rows:
        if row["name"] in by_path:
            row["launches_by_path"] = by_path[row["name"]]
        if row["name"] == "stream_axpy[sum]":
            row["launches_by_path"] = sum_by_path
    host_us = host_launch_us(cuda_op, fa, torch, dev)
    for row in rows:  # named stream_axpy[sum], ..., chain_add_one, flash_*
        key = {"tile_transpose_32": "transpose", "chain_add_one": "chain"}.get(
            row["name"], row["name"].split("[")[-1].rstrip("]"))
        row["host_us_per_launch"] = host_us[key]
        if key == "chain":
            row["add_host_us_per_launch"] = host_us["torch.add(x, 1)"]
    one_process_ms = time_allreduce(tuned, torch, dev)
    check(not bad_plans(tuned, "allreduce"),
          f"the sweep's plans are not graphs: {bad_plans(tuned)}")
    profile_allreduce(tuned, torch, dev)
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        " GiB")
    time_model(torch, model)
    time_train(torch, train_model)
    s14_timing = time_slice14(tuned, torch, train_model)
    s15["tune"] = s15_tune(torch)
    del model, train_model
    torch.cuda.empty_cache()
    time_moe(torch, moe_model)
    del moe_model
    torch.cuda.empty_cache()
    time_mixer(torch)
    tuned.free()
    mpi.finalize()
    torch.cuda.empty_cache()

    s9 = phase_slice9(tmvar, cuda_op, torch, dev)
    s9_by_row = {"flash_fwd": s9["mesh_a"]["flash_fwd"],
                 "flash_bwd_dq": s9["mesh_a"]["flash_bwd_dq"],
                 "flash_bwd_dkv": s9["mesh_a"]["flash_bwd_dkv"],
                 "stream_axpy[sum]": s9["mesh_a"]["sum"] + s9["mesh_b"]["sum"]
                 + s9["tree_sum"]}
    for row in rows:  # the main path's launches now include slice 9's
        if row["name"] in s9_by_row:
            row["launches"] += s9_by_row[row["name"]]
            row["launches_by_path"]["slice9"] = s9_by_row[row["name"]]
    time_slice9(torch)
    torch.cuda.empty_cache()
    report_slice10(s10, one_process_ms)
    for row in rows:
        if row["name"] == "stream_axpy[sum]":
            row["launches"] += s10["sum"] + s10["sum_s11"]
            row["launches_by_path"]["slice10"] = s10["sum"]
            row["launches_by_path"]["slice11"] = s10["sum_s11"]
            row["launches"] += s12["sum"]
            row["launches_by_path"]["slice12"] = s12["sum"]
    s13_by_row = {"stream_axpy[sum]": "sum", "flash_fwd": "flash_fwd",
                  "flash_bwd_dq": "flash_bwd_dq",
                  "flash_bwd_dkv": "flash_bwd_dkv"}
    for row in rows:  # slice 13's workers train the TpuLM over the wire
        key = s13_by_row.get(row["name"])
        if key is not None:
            row["launches"] += s13["launches"][key]
            row["launches_by_path"]["slice13"] = s13["launches"][key]
    s14_by_row = {"stream_axpy[sum]", "flash_fwd", "flash_bwd_dq",
                  "flash_bwd_dkv"}
    for row in rows:  # slice 14's workers, the plane on
        if row["name"] in s14_by_row:
            row["launches"] += s14["launches"][row["name"]]
            row["launches_by_path"]["slice14"] = \
                s14["launches"][row["name"]]
    for row in rows:  # slice 15's tenants, and tpu_tune's checks
        if row["name"] in s14_by_row:
            n15 = s15["launches"][row["name"]]
            if row["name"] == "stream_axpy[sum]":
                n15 += s15["tune"]["sum"]
            row["launches"] += n15
            row["launches_by_path"]["slice15"] = n15
        if row["name"] == "stream_axpy[sum]":  # slice 16's two processes
            row["launches"] += s16["sum"]
            row["launches_by_path"]["slice16"] = s16["sum"]
    report_slice12(s12)
    report_slice13(s13)
    report_slice14(s14, s14_timing)
    report_slice15(s15)
    report_slice16(s16, s10)
    run_bench(torch, dev)
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(card_line())
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
