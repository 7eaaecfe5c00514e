#!/usr/bin/env python3
"""GPU smoke of the PyTorch/H100 port (``dmlc_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. device   the card's name; its name and power limit as nvidia-smi
            gives them, on a line of their own
2. build    nvcc builds every kernel in ``dmlc_tpu_torch/ops/csrc``
            (one process per source, all at once); ptxas's register and
            spill lines, and from ``cuobjdump -sass`` (where the toolkit
            has it) the tensor-core instructions (HGMMA, HMMA) of each
            bf16 forward and backward kernel, which must use wgmma
3. flash    kernel K1 (flash-attention forward) against its plain
            PyTorch version on the card: B=1, H=16, D=128, T in
            {512, 1000}, causal and not, bf16 and f32, plus (pv, m, l)
            calls at non-zero offsets in both dtypes; kernel, plain and
            ``F.scaled_dot_product_attention`` (yardstick only) times
   flash_bwd  kernels K2 (dK/dV) and K3 (dQ) against the plain backward
            at the same shapes, then at the elastic phase's shape (B=8
            x T=128) and the two train shapes (B=8 x T=1024 and B=1 x
            T=8192; H=16, D=128, bf16, causal), where K1's output is
            held against the plain forward too; at the two
            train shapes each of K1, K2, K3 timed alone (with its
            TFLOP/s and share of its bound) and two launches of each held
            bit-identical, beside the plain versions and SDPA's forward
            and backward (yardsticks only)
4. paged    kernel K4 (paged decode attention) likewise: B=8, H=16,
            D=128, bf16 pools, block 16, windows S in {1, 4}; two
            launches held bit-identical
5. slice    the flagship model (full width and depth, random weights
            from seed 0) served by the port's engine behind its HTTP
            server (POST /generate on localhost): 8 requests, prompt
            lengths 17..511, 32 new tokens, then 8 looping prompts with
            speculative decoding (spec_k=3); kernel launch counts are
            zeroed just before and read just after; one prefill and one
            decode step are then held against the plain versions (gated
            on a float32 copy of the weights; bf16 reported beside its
            own rounding noise floor).  Every serving run here and below
            reads the compute ledger (``GET /compute``) and the decode
            records; gates: the memory sample is the card's
            (``hbm.source == "device"``), ``aot_fallbacks_total`` is 0
            (no cost pass failed), every decode record carries
            ``membw_util`` and ``bound``, the decode site's counted
            bytes are at least the bytes of the weights a step
            multiplies by, and (dense models) its counted FLOPs are
            within 10% of the step's ``decode_flops_per_token`` sum;
            numbers: the bound verdicts, phase shares, each site's cost
            passes with their seconds and signature counts, step p50
            and gap p99
   gather   the gather decode path (``DMLC_SERVE_PAGED_ATTN=off``): the
            same flagship and prompts at spec_k 0 and 3, K1 and K4
            counted from 0 (gates: K4 0, K1 equal to the paged run's);
            the bf16 token streams beside the paged run's (reported);
            a float32 copy at depth 2 served both ways (gate: equal
            greedy tokens) and one decode step of it (B=8, contexts
            17..511) paged against ``gather`` + ``forward_decode``
            (gate: logits within 1e-4 relative); step p50 and gap p99
            of both paths
6. train    the flagship train step (remat save_flash, AdamW lr 1e-4)
            at B=8 x T=1024: 2 warm-up and 8 timed steps on one batch,
            losses finite and falling, exactly 16 launches of each of
            K1, K2 and K3 per step (counts zeroed just before the timed
            steps); step ms, tokens/s, MFU, peak memory.  The first
            warm-up step is the ``train.step`` site's cost pass; gates:
            its counted FLOPs over ``train_step_flops`` above 1 (the
            backward counted, the remat's recompute on top), every
            timed record with ``membw_util`` and ``bound``, and then the
            five sites ``serving.prefill``, ``serving.decode``,
            ``serving.decode_spec``, ``serving.decode_paged`` and
            ``train.step`` each with a cost
   train_long  1 warm-up and 2 steps at B=1 x T=8192: finite losses, step
            ms, memory
   train_grads  gradients of the loss through the kernels against the
            plain versions on a float32 copy of the flagship at depth 2,
            B=2, T=1024 (bf16 reported beside its own noise floor)
   profile  device time by kernel category for one flagship prefill, one
            decode step and one train step at each shape
            (torch.profiler), beside their wall times
7. spine    the data spine under ``build/spine`` (removed at the end):
            a RecordIO shard of 512 records of 1025 int32 tokens written
            by the port; the flagship trained from it through
            ``recordio_feed`` (4 partitions x 2 records, B=8 x T=1024;
            2 warm-up steps, then 24 fed steps paired in ABBA order with
            steps on a batch already on the card): the first batch
            byte-exact against the records, losses finite and falling,
            16 launches of each of K1, K2 and K3 per step, the paired
            step ms and the feed wait; a fresh model's full train state
            (a depth-4 copy where build/ has under 14 GB free) saved
            through ``CheckpointManager`` after 2 fed steps, 2 more
            steps, restored bitwise into a fresh model and AdamW, and
            the same 2 steps from a feed fast-forwarded to the saved
            stream position (losses within 1e-3 relative); save,
            restore and CRC32C GB/s.  One epoch through the packed
            transport byte-equal to the padded route; then a 256 MB
            shard's payload MB/s into HBM on three routes (each route's
            first batch on the card equal to the CPU's) beside the pinned
            H2D rate at the same transfer size
   lockcheck  the serving and feed paths under the runtime checkers
            (``DMLC_LOCKCHECK=1`` and ``DMLC_RACECHECK=1`` set before the
            phase builds anything, restored after): two fresh flagship
            engines (pool 256 x 16, max_active 8) behind their HTTP
            servers under the ``LoadGenerator`` (8 streams x 2; K1
            prefills, K4 decodes), then 4 train steps of a fresh flagship
            fed by ``recordio_feed`` over a shard under
            ``build/lockcheck`` (K1-K3, the feed's threads and pool).
            Gates: ``lockcheck_report()`` and ``racecheck_report()``
            empty (what ``lockcheck_assert_clean`` and
            ``racecheck_assert_clean`` raise on), acquire sites observed,
            every kernel launched, plain locks again after.
            The same load runs with plain locks before and after the two
            checked runs (ABBA): the decode step p50s are the checkers'
            cost
   interleave  the deterministic interleaving explorer
            (``analysis.interleave``) over the port's classes: the
            reverted drain (``drain_pre_pr13``) caught within 400
            schedules of seed 0 with the sweep error and replayed to the
            same error and decisions; the five scenarios clean at 64
            schedules each (seed 0), the drain scenario's engine, tiny
            model and KV pool on the card (no forward runs there: K1-K4
            launch 0 times); then a fresh engine of the scenario's
            ``max_active`` (2; a tiny model with D=64 heads, which K1 and
            K4 take) serves 2 requests on the card while a thread reads
            ``/compute``, tokens equal to a CPU engine's on the same
            weights (K1 and K4 launched).  Gates on all of it and a 20 s
            budget
   remote   remote filesystems (under ``build/remote``, removed after):
            ``chip_stores.py``'s S3 (SigV4 countersigned, multipart) and
            GCS (JSON API, resumable uploads) emulators in a child
            process; the port's RecordIO writer puts the LM example's
            ``make_data`` shard and the spine's 268,433,152 B feed shard
            to ``s3://`` (``DMLC_S3_WRITE_BUFFER_MB=8``: 32 parts), the
            feed shard copied on to ``gs://`` and a local file.  Three
            runs of ``train_lm_recordio.run`` from the ``s3://`` shard,
            the flagship's widths at depth 2 (bf16, seed 0): (a) 6 steps,
            (b) 4 steps saving to ``gs://``, (c) a fresh model resumed
            from there for steps 5-6 after a torn step 5 (a shard, no
            manifest) is put above the save.  Gates: the shard byte-equal
            to ``make_data``'s file and the feed shard in its parts; the
            first ``s3://`` batch byte-exact against the records; an
            epoch with ``DMLC_INTEGRITY_VERIFY_READS=1`` and
            ``storage.response@fetch:read=corrupt::2`` equal to a clean
            epoch batch for batch, 2 responses corrupted and 2
            ``integrity/read_verify_failures``; ``latest_step`` 4 over
            the torn step; (c) resumed at step 4 and stream position 4,
            its restored state bitwise equal to (b)'s save, its losses
            within 1e-3 relative of (a)'s steps 5-6; 2 launches of each
            of K1, K2 and K3 in every step; step 6 the latest after (c).
            Numbers: upload and copy MB/s, step ms, saved bytes, save and
            restore GB/s, and the 256 MB shard's payload MB/s into HBM on
            the ``recordio_packed_feed`` route from the local file,
            ``s3://`` and ``gs://`` (each first batch on the card equal
            to the CPU's)
   options  the flagship's model options (the dense serving model freed
            first): ``save_flash_mlp`` — the dense flagship train step
            at B=8 x T=1024 under save_flash and save_flash_mlp, two
            models from one seed stepped in ABBA order (6 pairs) on one
            batch: losses equal step by step, step ms, peak memory above
            the train state, device ms and calls of the in/gate products
            (torch.profiler); ``moe_serve`` — the routed flagship (top-2
            of 8 experts, capacity factor 1.25, 5.2B params, bf16)
            behind the HTTP server: 8 requests at spec_k 0 and 8 at
            spec_k 3, K1 and K4 launch counts zeroed just before, then a
            pass with ``moe_debug_overflow`` for the dropped-choice
            fraction; ``moe_train`` — 4 AdamW steps of it at B=8 x
            T=1024 through ``make_train_step(grad_norm=True)``: losses
            finite and falling, finite norms, 16 launches of each of
            K1-K3 a step; step ms, peak memory, executed against the
            ledger's FLOPs, and device time by category of a routed
            prefill, decode step and train step; ``moe_check`` — it at
            depth 2 in float32, kernels against plain versions: the
            (token, choice) routes agree (>= 0.999), logits and
            gradients on the agreeing tokens within 1e-4; ``selfheal`` —
            the port's LM trainer on the card from a ``make_data`` shard
            under ``build/selfheal`` (removed after): an oracle run of 30
            steps (commits every 20), a faulted run (3 poisoned steps at
            step 21: 2 skips, a rollback, the replay) equal to it, a run
            with one transient skip and a drift run (that skip, then a
            rollback) equal to it, having replayed the 21 batches
            snapshotted at the commit; the ``dmlc_selfheal_*`` counters;
            then the faulted run again under a port ``RabitTracker`` at
            world 1 (``DMLC_ELASTIC=1``, in this process), held to the
            oracle the same way, the tracker's ``/anomalies`` showing
            rank 0's remediation (``rollback``, 2 skips, 1 rollback)
   elastic  the port's elastic LM trainer under ``build/elastic``
            (removed after): the flagship's widths at depth 1 (188M
            params, bf16, ``save_flash``, seed 0) on ``make_data``'s
            shard, 3 workers of ``python -m dmlc_tpu_torch.tracker.submit
            --cluster local --num-workers 3`` with ``DMLC_ELASTIC=1``
            sharing the card (each an entry of this script,
            ``--elastic-worker``, calling ``train_lm_recordio.run``); one
            SIGKILLed after the step-5 commit (the job commits every 5
            steps), the survivors shrink to 2, ``POST /resize
            {"world": 3}`` and a fresh worker (started at the kill,
            entering the job after the request) grow the world back, 11
            steps in all.  Gates: both resizes on every survivor
            (resynced at step 5, then at world 3), /metrics
            ``dmlc_elastic_resizes_total`` >= 2, every step's loss one
            value on every rank, finite and falling, equal final-param
            SHA-256s, ``n_layers`` launches of each of K1-K3 per loss
            evaluation on every rank, /goodput's per-rank and cluster
            buckets summing to wall within 2% with ``resize`` and
            ``checkpoint_restore`` non-zero and ``unattributed`` under
            10%, no process or ``/dev/shm/dmlc*`` segment left.  The
            tracker's endpoints are read once a second through the job
            (an error status fails the smoke, and so does a good
            reading after a response cut short: only the tracker's exit
            with the job may cut one); gates on the last good reading: ``/trace`` a row per shipping
            rank (pid = rank +
            1) and the tracker's at pid 0, a ``step`` span of every live
            rank, spans in the order they ended within a (pid, thread);
            ``/anomalies`` every live rank with steps and a finite
            positive step time, every flag's kind a watchdog kind;
            ``/compute`` every live rank traced (its own ledger naming
            ``train.step``), no storm; ``/incidents`` an incident of the
            kill (its window, reached back by the shm wait the survivors
            take to see the death plus 2 s, holds the kill's wall time)
            with ``resize`` or ``preempted`` badput and the
            ``world_resized`` event; ``/metrics`` valid exposition text
            with every family registered.  Numbers: step p50 at world
            3, 2 and 3, the ledger's collective and feed-wait shares,
            kill → first step after the resync and /resize → first step
            at world 3, each state broadcast's bytes and seconds and
            rank 0's restore, every goodput bucket's fraction per rank;
            spans held per rank, ``/trace``'s bytes and read ms, the
            flags and verdicts against the kill time, the incidents'
            windows and buckets (``tracker``); job logs in
            ``chiprun_out/elastic_*.log``, the tracker's last documents
            in ``chiprun_out/elastic_tracker_docs.json``
   mesh     the sharded flagship over ``torch.distributed`` (under
            ``build/mesh``, removed after): first K1 alone at the mesh
            train step's ring-step shape (B=2, T_local=2048, 8 heads,
            D=128, bf16) at a diagonal and a fully visible block's
            offsets, held against its plain version and timed beside it
            and SDPA; then ``dmlc_tpu_torch.examples.psum_worker`` as a
            4-worker job (each rank's all-reduce of rank+1 equal to
            10), beside two ranks of ``chip_smoke.py --gloo-probe``
            that hand gloo each op on a CUDA tensor (gate: all but
            point-to-point taken and right; every verdict goes on the
            line and into ``chiprun_out/gloo_probe.log``); then 4
            workers of ``python -m dmlc_tpu_torch.tracker.submit
            --cluster local --num-workers 4`` sharing the card (each
            ``chip_smoke.py --mesh-worker``: ``initialize_distributed()``,
            which picks gloo for ranks that share a card, and
            ``build_mesh(dp=1, sp=2, tp=2)``).  Gates: ring attention
            alone on q/k/v [1, 8192, 16, 128] bf16, causal, output and
            q/k/v gradients against ``flash_attention`` on the gathered
            sequence (bf16 tolerances) with sp launches
            of K1 a call; Ulysses with ``attn_fn=flash_attention`` the
            same; the flagship's widths at depth 2 in float32, B=2 x
            T=2048: the sharded loss within 2e-5 relative of one
            process's ``unsharded_loss`` and every gathered gradient
            within 1e-4 of its max; 3 bf16 AdamW steps of
            ``make_train_step(model, mesh=mesh)`` at global B=2 x
            T=4096 (remat ``save_flash``, seed 0): one loss per step on
            all ranks, falling, and each leaf's SHA-256 equal on the
            ranks that hold the same shard.  Numbers: the backend, step
            p50 per rank, K1 launches per ring call and per step, bytes
            per step by collective and the ring's K/V shifts staged
            through host memory, the ring's and Ulysses' forward ms,
            the card's name and power limit; the ``--gloo-probe`` ops
            include ``all_reduce(async_op=True)`` (gated as the others)
   mesh5    the rest of the five-axis mesh (under ``build/mesh5_*``,
            removed after): first K1, K2 and K3 alone at the gangs'
            shapes ([2, 1024, 16, 128] and [2, 2048, 8, 128], bf16,
            causal) against their plain versions (K2/K3 at the bf16
            ``GRAD_TOL``), K1 timed beside its plain version and SDPA;
            then one job of 4 workers of the port's launcher sharing
            the card over gloo (each ``chip_smoke.py --mesh5-worker``),
            which runs gang A and then gang B, each on its own
            ``build_mesh`` over the same ranks.  Gang A: the
            flagship's widths at depth 2 on pp2 x dp2 (1 layer a stage,
            2 microbatches, global B=8 x T=1024, seed 0); gang B: the
            routed flagship (top-2 of 8, capacity factor 1.25) at depth
            2 on ep2 x tp2 (4 experts x half of d_ff and 8 heads a rank,
            B=2 x T=2048).  Gates, each gang: a depth-2 float32 copy on
            the gang's mesh against one process (loss within 2e-5
            relative, every gathered gradient within 1e-4 of its max;
            gang B's route agreement reported); 1 warm-up and 3 bf16
            AdamW steps of ``make_train_step(mesh=...)`` with one loss
            per step on every rank, falling, each leaf's SHA-256 equal
            on the ranks that hold the same shard, and (M+P-1) x L/P
            launches of each of K1-K3 a step a rank (3 in gang A, 2 in
            gang B).  Gang A also: the same steps from the same start
            with ``overlap="device"``, losses within 1e-2 relative of
            the fused reduction's (bit-equality reported), every leaf
            after the steps bit-equal to the fused run's and each leaf's
            SHA-256 equal on the ranks that hold it; the train
            state after the steps saved with specs
            (``save_pytree(..., mesh=, specs=)``), restored into a fresh
            model and AdamW bitwise, and one more step from each with
            equal losses and SHA-256s.  Gang B also: one call under
            ``moe_debug_overflow``, its dropped-choice fraction equal on
            the ranks of one ep coordinate.  Numbers: step p50, peak
            memory, pp bytes staged, all-reduce bytes, buckets and the
            exposed (dp, sp) wait a step a rank, save and restore
            seconds
   shard_serve  sharded serving (after ``mesh5``, under
            ``build/shard_serve``, removed after): first K1 (B=1, T=512)
            and K4 (B=8, S in {1, 4}, the paged phase's engine lengths)
            at a tp=2 rank's 8 heads, bf16, against their plain versions,
            timed beside SDPA; then 4 workers of the port's launcher
            sharing the card over gloo (each ``chip_smoke.py
            --shard-serve-worker``: ``initialize_distributed()``,
            ``build_mesh(dp=2, tp=2)``), the flagship's widths at depth
            8 (cut from 16 for the smoke's time) from seed 0, each rank
            its shards (8 heads, half of d_ff and vocab).  Each run
            builds ``InferenceEngine(model, mesh=mesh)`` on every rank:
            rank 0 serves it behind the port's HTTP server, ranks 1-3
            run ``follow()``.  After one short warm-up request (as the
            slice phase's), runs: the slice phase's 8 requests on
            ``auto`` (the gather path, the batch padded to 8 and split
            over dp) at spec_k 0, its 8 looping ones at spec_k 3, the 8
            again under ``DMLC_SERVE_PAGED_ATTN=on`` (K4 on each rank's
            heads, the batch whole on each dp rank).  Gates: every
            request 200 with 32 tokens; on every rank, counted from 0
            just before each run, K1 ``n_layers`` a prefill, K4 none on
            the gather runs and ``n_layers`` a decode step on the paged
            one; every rank exits 0 and no process is left; a float32
            copy at depth 2 on the same mesh (gather at spec_k 0 and 3,
            paged at 0) gives the greedy tokens of a one-card f32
            engine on rank 0, and its sharded prefill (T=512) and decode
            step (B=8, contexts 17..511, both paths) are within 1e-4
            relative of the one-card forwards.  Numbers: tokens/s, TTFT
            p50/p99, decode step p50, gap p99 per run beside the
            one-card slice and gather runs; rank 0's collective calls and
            bytes per decode step and the bytes the port stages through
            pinned host memory (per run, and one counted step a path at
            the served depth) and its counted decode cost over the global
            step's FLOPs (reported); spawn → first request served; the
            phase wall
   shard_serve_wide  sharded serving on the rest of the mesh: the 4
            workers of ``shard_serve``'s job, after its gang, serve two
            more in turn, each on its own ``build_mesh`` over the same
            ranks (one spawn for the three).  Gang R: the
            routed flagship (top-2 of 8, capacity factor 1.25) at full
            width and depth 8 (cut from 16 for time) on dp2 x ep2, 4 experts
            a rank; gang P: the flagship's widths at depth 8 on pp2 x
            tp2, 4 layers and 8 heads a rank.  Weights are drawn from
            seed 0 leaf by leaf and layer by layer, each rank keeping
            its shards (``seeded_model``).  Each gang: one warm-up
            request, then the slice phase's 8 requests on ``auto`` (the
            gather path on both meshes, as the reference's ``auto``
            picks; gang R's routed FFN gathers every row's choices over
            dp) and on ``on`` (paged) at spec_k 0, behind rank 0's HTTP
            server.  Gates: every request 200 with 32 tokens; on every
            rank, counted from 0 just before each run, K1 its local
            layers a prefill, K4 its local layers a decode step on the
            paged run and none on the gather run; every rank exits 0;
            a float32 copy at depth 2 on the gang's mesh (both runs,
            every request submitted before the engine starts, so that
            the routed gang batches as one card does) gives the greedy
            tokens of a one-card f32 engine on rank 0,
            its sharded prefill and decode step (both paths) within
            1e-4 relative of one card's; for gang R the paged run's
            dropped-choice fraction (``moe_debug_overflow``, each call's
            counts summed over ep) equal to the one-card run's.
            Numbers: tokens/s, TTFT p50/p99, decode step p50 and gap
            p99 per gang and run beside one card's (the slice, gather
            and routed serving runs) and ``shard_serve``'s; rank 0's
            collective calls and bytes per decode step (per run, and one
            counted step a path: the pp handoff, the ep/tp all-reduces,
            the dp gather of the routed choices, the logits broadcast
            over pp); K1/K4 launches per rank; the f32 numbers and the
            gather run's dropped fraction (reported: it routes the dead
            rows the batch is padded with too)
   telemetry  the port's ``LoadGenerator`` drives the port's server (the
            flagship, spec_k=3, seed 0): 8 streams x 2 requests, prompts
            of 17..511 tokens, 32 new tokens; gates: /metrics parses as
            exposition text, /requests holds one finished record per
            request, a duplicate request_id returns the original's
            tokens without a second prefill (K1's count does not move),
            a drain started during a request finishes it and answers the
            next POST with 503; the ledger's own host cost per step
            (empty steps timed on the card).  The train phase's 8 timed
            steps run through the step ledger (gate: its MFU within 1%
            of the smoke's own over the same steps), then 12 ABBA pairs
            of ledgered against bare steps; the spine's fed steps report
            the ledger's feed-wait share beside the feed's own wait, and
            a checkpoint save made inside a step its stall.  All of it
            goes on one ``telemetry`` line, beside the card's name and
            power limit
8. sparse   dmlc-core's sparse text path under ``build/sparse`` (removed
            at the end): a ~256 MB LibSVM file in the Criteo Display
            Advertising Challenge's row shape (a 0/1 label from a planted
            logistic model, 13 integer and 26 hashed categorical
            features, indices in [0, 2^20)) and a 1,000,000-row CSV in
            UCI HIGGS's (a label, 28 floats), written from seed 0; each
            through ``libsvm_feed`` onto the card at 4 partitions x 2048
            rows (LibSVM on the fused native route and, as ``fmt="auto"``,
            on the classic route, ``create_row_iter`` + ``pack_rowblock``;
            CSV on the classic route): gates: each route's first batch
            equal to the same route on the CPU, the LibSVM routes' epoch
            row counts and checksums equal; text MB/s, placed MB/s, rows/s, parse and
            consumer-wait seconds beside the pinned H2D rate; 50 SGD
            steps on fed batches of the examples' logistic loss (a [2^20]
            weight) and squared loss, both falling; then the spine's
            RecordIO routes' MB/s through the native scan and packs
            beside the rates of the numpy route they replaced (one
            ``sparse_recordio`` line)
   tracker  dmlc-core's tracker, launcher and host collectives, run as
            ``python -m dmlc_tpu_torch.tracker.submit --cluster local
            --num-workers 4`` jobs on the sparse phase's files before
            they are removed: ``train_libsvm`` on the first 49152 rows
            of the Criteo-shaped file (a sixteenth of it: the smoke's
            time limit; 2 epochs, a [2^20] weight on the card,
            an 8 MB f64 gradient allreduced every step) — gates: every
            rank logs both epochs, the mean epoch loss falls, the four
            final-weight SHA-256s are equal, every gradient allreduce ran
            on ``hier``; the
            rendezvous seconds (the tracker's listen to its last rank
            assigned), steps/s, epoch seconds, allreduce ms p50/p99 and
            share of the step; the same job on the file's first 32768
            rows on the card and with ``--device cpu`` — gate: every
            rank's unrounded epoch losses agree within 1e-5 relative;
            ``train_csv`` on the HIGGS-shaped CSV's first 125000 rows
            (an eighth, for time; mse falls); the
            ``allreduce_worker bench 16777216 3`` sweep (tree, ring and
            hier algbw/busbw, the bucketed-overlap pass's exposed and
            overlapped seconds, the 16 leaves as CUDA tensors through
            the GradientBucketer equal to the numpy pass); the repo's
            ``examples/gbdt_allreduce.c`` built with gcc against the
            port's ``dmlc_collective`` and run with 4 workers, matching
            its single-process RMSE.  Beside the numbers: the card's
            name and power limit, its compute mode, the host's CPU
            count, the free /dev/shm and the shm group's chunk.  Gates:
            no launched process and no new ``/dev/shm/dmlc*`` segment
            left behind
   router   the fleet router (after the telemetry line, the smoke's own
            serving models freed): two replicas, each ``python -m
            dmlc_tpu_torch.serving.serve --model flagship --layers 2
            --seed 0`` (full width, depth 2 since the ``remote`` phase
            came, bf16, KV pool 256 x 16, max_active 8,
            ``DMLC_TRACE_FLEET=1``, 2 OMP threads) sharing the card, each
            warmed by one request, behind ``python -m
            dmlc_tpu_torch.serving.route`` (health every 0.25 s, probe
            backoff 0.25..2 s); the port's ``LoadGenerator`` (8 streams x
            2 prompts of 17..511 tokens, 32 new tokens, seed 0) runs
            (1) straight at replica A, (2) at the router, (3) at the
            router with B SIGKILLed after the 4th completion, then (4) B
            restarts on its old port and bursts of 4 requests go through
            the router until one is served by B, and (5) a run at the
            router with SIGTERM to A after the 4th completion.  Gates:
            every request of runs 1-3 and 5 answered 200 at its first try
            (no 429, no 503); /metrics valid exposition text with
            ``dmlc_router_failovers_total`` >= 1 after run 3; a torn
            request is one trace (``/trace/<id>``: ``router.dispatch`` on
            both replicas, the survivor's serving spans) and the merged
            ``/trace`` holds ``ph:"s"/"f"`` flow arrows; B ``healthy``
            within the probe backoff of listening again and then serving;
            A drained and exited 0, the router's ``dmlc_router_http_503``
            0; K1 and K4 launched in every replica that served (its
            ``/healthz`` ``kernel_launches`` from its warm-up on); no
            process, port or ``/dev/shm/dmlc*`` segment left.  Numbers:
            client TTFT p50/p99, latency p99 and tokens/s of runs 1-3, the
            router's latency p50/p99 and the ms it adds a request (client
            minus replica latency, routed minus direct), kill -> B
            ``down`` and -> the first failed-over completion, restart ->
            ``healthy``, drain -> last 200 and -> A's exit, K1 and K4
            launches per replica; logs in ``chiprun_out/router_*.log``
   fleet    the fleet control plane (after ``router``, under
            ``build/fleet``, removed after): a 2-rank elastic job beside
            the fleet — each rank ``chip_smoke.py --fleet-worker`` under
            an in-process port ``RabitTracker(elastic=True)``: full-batch
            least squares on 240 records of 7 features in a RecordIO
            shard, the gradient in float64 on the card summed by
            ``TrackerClient.allreduce_sum``, lr 0.05, 50 steps 0.2 s
            apart, rank 0 checkpointing every step, both ranks parked at
            steps 20 and 40 until the phase lets them on; two replicas
            as in ``router`` (A, B; depth 2) behind the port's
            ``Router`` in this process (``TenantGovernor(rate=0)``, paid weight 50, free 1)
            and its ``RouterHTTPServer(fleet_source=)``, with the port's
            ``Autoscaler`` (interval 0.3 s, water 0.7 / 0.15, hysteresis
            2, cooldown 3 s, 2..3 replicas) over a
            ``TrainingPreemptingProvider``.  Spike: 16 streams x 6
            prompts of 17..511 tokens, 32 new tokens, each stream's last
            request held until the scaled replica is registered; the
            controller kills rank 1 (parked), posts the shrink with it
            on the remove list and starts replica C.  Gates: one
            scale-up, 3 replicas, the job at world 1 after one
            preemption, every request 200, C served some and launched
            K1/K4 after its warm-up.  Tail: 2 streams x 10 such
            requests while the controller drains C (``set_draining``,
            SIGTERM, the relaunched rank, the grow resize); gates: one
            scale-down, every request 200, no 503 at the client or the
            router, C exits 0 after its drain line.  Regrow: the world
            back at 2, rank 1 exited by SIGKILL and the others 0, rank
            0's 50 losses within 1e-6 relative of the numpy oracle and
            the final weights within rtol 1e-6, atol 1e-9.  Tenants (the
            bucket at 2 requests/s a weight): 3 paid and 3 free streams
            x 4 prompts; free absorbs a 429, paid none.  Exposition:
            /metrics valid with ``dmlc_fleet_*`` (2 replicas, 0 owned,
            1 scale-up, 1 scale-down) and ``dmlc_tenant_*``; /fleet's
            counters; /decisions holds the preemption chain and then the
            restore chain in order; /incidents one incident with the
            chain.  Numbers: verdict -> registered split into kill,
            resize ack, spawn -> listening and warm-up; spike and tail
            TTFT and latency; requests by replica; ``set_draining`` ->
            C's exit; K1/K4 launches per replica (A and B from their
            warm-up, C to its drain); logs in
            ``chiprun_out/router_{A,B,C}.log`` and
            ``chiprun_out/fleet_worker_*.log``
9. kernels  one line ``{"kernels": [...]}``: per kernel its launches on
            its path (and on the spine's timed steps, and in
            ``path_launches`` on the gather path, the routed serving and
            train paths, the self-heal runs, the elastic job, the mesh
            phase's ring, Ulysses and train runs, the mesh5 gangs'
            timed steps, the shard_serve ranks' three runs, the
            shard_serve_wide ranks' runs of both gangs, the router
            phase's replicas and the fleet phase's three),
            max error, times and roofline bound; K1's ``ring_step``,
            ``mesh5_shapes`` and ``shard_serve_shape`` rows, K4's
            ``shard_serve_shapes``

Every phase line carries ``at_s``, the seconds since the smoke started.
The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card
the script exits with code 2 and prints no result.  Details go to
``chiprun_out/chip_smoke.json``.
"""

import dataclasses
import gc
import itertools
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.client import HTTPException
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM dense
PEAK_BYTES = 3.35e12
BF16_TOL = (2e-2, 2e-3)   # max, mean abs error: ~1 bf16 ulp of the output
F32_TOL = 1e-4            # f32, summation order only
LOGIT_TOL = 2e-2          # max |kernel - plain| / std(logits), f32 model
# backward kernels, |g - g_plain| / |g_plain| per gradient: f32 summation
# order only; bf16 one rounding of each gradient (an ulp is 2^-8 ~ 3.9e-3)
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
TRAIN_GRAD_TOL = 1e-4     # max over params of |dg| / |g_plain|, f32 model
TRAIN_B, TRAIN_T = 8, 1024   # bench.py's train shapes
ELASTIC_T = 128   # the LM example's SEQ, the elastic phase's T
LONG_T = 8192

RESULTS = {}
T_START = None   # main()'s start; every emitted line carries its offset
TELEMETRY = {}   # the telemetry line, filled by the serving, train and spine phases


def emit(doc):
    if T_START is not None:   # seconds into the smoke, where the time goes
        doc.setdefault("at_s", time.perf_counter() - T_START)
    print(json.dumps(doc), flush=True)
    RESULTS.setdefault("lines", []).append(doc)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, iters=20, warmup=3):
    """Device ms per call.  A ~20 ms spin kernel goes first, so the host
    has enqueued the timed calls before the first one starts and a slow
    host cannot stretch the events' interval."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(35_000_000)      # cycles: ~20 ms at 1.7-2 GHz
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def errors(got, want):
    d = (got.float() - want.float()).abs()
    return d.max().item(), d.mean().item()


def bound_ms(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def sass_mma_counts(libs):
    """Tensor-core instructions in each bf16 flash kernel of the built
    libraries, from ``cuobjdump -sass``: ``{kernel<D[, normalize]>:
    {"HGMMA": n, "HMMA": m}}`` (wgmma and mma.sync); None where the
    toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = "\n".join(subprocess.run(
        [tool, "-sass", str(lib)], capture_output=True, text=True,
        timeout=300, check=True).stdout for lib in libs)
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"(flash_(?:fwd|bwd_dkv|bwd_dq)_kernel_bf16)"
                          r"ILi(\d+)E(?:Lb([01])E)?", line)
            name = (f"{m.group(1)}<{m.group(2)}"
                    f"{', ' + m.group(3) if m.group(3) else ''}>"
                    if m else None)
            if name:
                counts[name] = {"HGMMA": 0, "HMMA": 0}
        elif name:
            for op in ("HGMMA", "HMMA"):
                counts[name][op] += bool(re.search(rf"\b{op}\.", line))
    return counts


# ---------------------------------------------------------------------------
# phase 3: K1
# ---------------------------------------------------------------------------

def flash_phase(fa):
    gen = torch.Generator("cuda").manual_seed(1)
    b, h, d = 1, 16, 128
    main, worst = None, 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for t in (512, 1000):
            q, k, v = (torch.randn((b, t, h, d), generator=gen,
                                   device="cuda").to(dtype) for _ in range(3))
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            for causal in (True, False):
                got = fa.flash_attention(q, k, v, causal=causal)
                want = fa.flash_attention(q, k, v, causal=causal,
                                          impl="torch")
                torch.cuda.synchronize()
                mx, mean = errors(got, want)
                if dtype == torch.bfloat16:
                    check(mx <= BF16_TOL[0] and mean <= BF16_TOL[1],
                          f"flash bf16 T={t} causal={causal}: {mx} {mean}")
                else:
                    check(mx <= F32_TOL, f"flash f32 T={t}: {mx}")
                worst = max(worst, mx)
                pairs = t * (t + 1) // 2 if causal else t * t
                flops = 4.0 * b * h * pairs * d
                # q, k, v read and o written once, m and l written (f32)
                nbytes = 4 * b * t * h * d * q.element_size() + 2 * b * h * t * 4
                bnd, by = bound_ms(flops, nbytes, dtype)
                row = {
                    "phase": "flash", "dtype": str(dtype).split(".")[1],
                    "B": b, "T": t, "H": h, "D": d, "causal": causal,
                    "max_abs_err": mx, "mean_abs_err": mean,
                    "ms": time_ms(lambda: fa.flash_attention(
                        q, k, v, causal=causal)),
                    "plain_ms": time_ms(lambda: fa.flash_attention(
                        q, k, v, causal=causal, impl="torch"), iters=5),
                    "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal)),
                    "bound_ms": bnd, "bound_by": by,
                }
                emit(row)
                if dtype == torch.bfloat16 and t == 512 and causal:
                    main = row
    # the ring-step (pv, m, l) contract at non-zero offsets, including a
    # KV range past every query (rows with no visible key); m and l come
    # from f32 scores in both dtypes, o = pv / l carries bf16's rounding
    # of P in bf16
    for dtype in (torch.float32, torch.bfloat16):
        for q_off, kv_off, tq, tk in ((512, 0, 256, 768), (0, 64, 128, 192)):
            q, k, v = (torch.randn((b, t, h, d), generator=gen,
                                   device="cuda").to(dtype)
                       for t in (tq, tk, tk))
            kw = dict(scale=d ** -0.5, causal=True, q_offset=q_off,
                      kv_offset=kv_off)
            pv, m, l = fa.block_attend(q, k, v, **kw)
            pv_r, m_r, l_r = fa.block_attend(q, k, v, impl="torch", **kw)
            torch.cuda.synchronize()
            o = pv / l.clamp_min(1e-20).transpose(1, 2)[..., None]
            o_r = pv_r / l_r.clamp_min(1e-20).transpose(1, 2)[..., None]
            e_o, mean_o = errors(o, o_r)
            e_m = errors(m, m_r)[0]
            e_l = ((l - l_r).abs() / l_r.clamp_min(1.0)).max().item()
            dead = l_r == 0
            check(all(torch.isfinite(x).all() for x in (pv, m, l)),
                  "non-finite (pv, m, l)")
            check(bool((l[dead] == 0).all() and (m[dead] == -1e30).all()),
                  "rows with no visible key: want m = -1e30, l = 0")
            o_ok = (e_o <= F32_TOL if dtype == torch.float32 else
                    e_o <= BF16_TOL[0] and mean_o <= BF16_TOL[1])
            check(o_ok and max(e_m, e_l) <= F32_TOL,
                  f"block_attend {dtype} offsets {q_off}/{kv_off}: "
                  f"{e_o} {mean_o} {e_m} {e_l}")
            emit({"phase": "flash_offsets", "dtype": str(dtype).split(".")[1],
                  "q_offset": q_off, "kv_offset": kv_off, "Tq": tq, "Tk": tk,
                  "o_err": e_o, "o_mean_err": mean_o, "m_err": e_m,
                  "l_rel_err": e_l, "rows_without_key": int(dead.sum())})
    return main, worst


# ---------------------------------------------------------------------------
# phase 3: K2 and K3
# ---------------------------------------------------------------------------

def rel_norm(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def bwd_inputs(gen, b, t, h, d, dtype, causal):
    """q, k, v, dO from ``gen`` and the forward's (o, lse) from K1."""
    q, k, v, do = (torch.randn((b, t, h, d), generator=gen,
                               device="cuda").to(dtype) for _ in range(4))
    o, lse = torch.ops.dmlc_tpu_torch.flash_attn_fwd(q, k, v, d ** -0.5,
                                                     causal, None)
    return q, k, v, o, lse, do


def bwd_check(fa, args, row):
    """K2 and K3 on ``args`` against the plain backward: each gradient's
    relative-norm error within ``GRAD_TOL`` (and in f32 each element
    within 3e-4 + 1e-3 |ref|); adds the errors to ``row`` and emits it."""
    dtype = args[0].dtype
    kw = dict(scale=row["D"] ** -0.5, causal=row["causal"])
    got = fa.flash_backward(*args, **kw)
    want = fa.flash_backward_reference(*args, **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        check(bool(torch.isfinite(g).all()), f"non-finite {name} {row}")
        err = rel_norm(g, w)
        mx = (g.float() - w.float()).abs().max().item()
        check(err <= GRAD_TOL[dtype], f"{name} {row}: rel err {err}")
        if dtype == torch.float32:
            excess = ((g - w).abs() - 3e-4 - 1e-3 * w.abs()).max().item()
            check(excess <= 0, f"{name} {row}: max abs {mx}")
        row[f"{name}_rel_err"] = err
        row[f"{name}_max_abs_err"] = mx
    emit(row)
    return row


def fwd_check(fa, q, k, v, o):
    """K1's ``o`` (from the op the train step calls) against the plain
    forward, bf16 tolerances; returns the max abs error."""
    want = fa.attention_reference(q, k, v, causal=True)
    mx, mean = errors(o, want)
    check(mx <= BF16_TOL[0] and mean <= BF16_TOL[1],
          f"flash fwd B={q.shape[0]} T={q.shape[1]}: {mx} {mean}")
    return mx, mean


def fwd_timing(fa, q, k, v, b, t, h, d, phase="flash_fwd_train_shape"):
    """K1 timed alone on q, k, v (bf16, causal, o normalised as the
    train step calls it), two launches held bit-identical, beside the
    plain forward and SDPA's forward (yardstick only); emits and returns
    its row."""
    kw = dict(scale=d ** -0.5, causal=True, q_offset=0, kv_offset=0,
              normalize=True)
    first = fa._launch(q, k, v, **kw)
    second = fa._launch(q, k, v, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(first, second))
    check(same, f"flash_fwd B={b} T={t}: two launches differ")
    del first, second
    ms = time_ms(lambda: fa._launch(q, k, v, **kw))
    plain_ms = time_ms(lambda: fa.attention_reference(q, k, v, causal=True),
                       iters=5)
    torch.cuda.empty_cache()
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    del qt, kt, vt
    flops = 4.0 * d * b * h * (t * (t + 1) // 2)
    # q, k, v read and o written once (bf16), m and l written (f32)
    bnd, by = bound_ms(flops, 4 * q.numel() * q.element_size()
                       + 2 * b * h * t * 4, torch.bfloat16)
    row = {"phase": phase, "B": b, "T": t, "H": h, "D": d,
           "dtype": "bfloat16", "causal": True, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "SDPA forward", "bound_ms": bnd, "bound_by": by,
           "gflop": flops / 1e9, "tflops": flops / ms / 1e9,
           "bound_share": bnd / ms, "over_library": ms / library_ms,
           "bit_identical": same}
    emit(row)
    return row


def bwd_timing(fa, args, b, t, h, d):
    """K2 and K3 each timed alone on ``args`` (bf16, causal), two
    launches of each held bit-identical, beside the plain backward and
    SDPA's backward (yardstick only: one call computes K2's and K3's
    outputs together); emits and returns one row per kernel."""
    q, k, v, o, lse, do = args
    kw = dict(scale=d ** -0.5, causal=True)
    bwd = fa._Backward(*args, **kw)
    ms, same = {}, {}
    for name, launch, outs in (
            ("flash_bwd_dkv", bwd.launch_dkv, lambda: (bwd.dk, bwd.dv)),
            ("flash_bwd_dq", bwd.launch_dq, lambda: (bwd.dq,))):
        launch()
        first = [x.clone() for x in outs()]
        launch()
        torch.cuda.synchronize()
        same[name] = all(torch.equal(x, y) for x, y in zip(first, outs()))
        check(same[name], f"{name} B={b} T={t}: two launches differ")
        ms[name] = time_ms(launch)
    del bwd, first
    plain_ms = time_ms(lambda: fa.flash_backward_reference(*args, **kw),
                       iters=5)
    torch.cuda.empty_cache()
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    library_ms = time_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dot, retain_graph=True))
    del ot, qt, kt, vt, dot
    pairs = b * h * t * (t + 1) // 2
    el = q.element_size()
    inputs = 4 * q.numel() * el + 2 * b * h * t * 4      # q dO k v, lse delta
    rows = {}
    for name, flops, out in (("flash_bwd_dkv", 8.0 * d * pairs, 2),
                             ("flash_bwd_dq", 6.0 * d * pairs, 1)):
        bnd, by = bound_ms(flops, inputs + out * q.numel() * el,
                           torch.bfloat16)
        rows[name] = {"ms": ms[name], "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": bnd,
                      "bound_by": by, "gflop": flops / 1e9,
                      "tflops": flops / ms[name] / 1e9,
                      "bound_share": bnd / ms[name],
                      "bit_identical": same[name]}
    emit({"phase": "flash_bwd_train_shape", "B": b, "T": t, "H": h, "D": d,
          "dtype": "bfloat16", "causal": True,
          "library": "SDPA backward, dq+dk+dv in one call",
          "k2_plus_k3_over_library": (ms["flash_bwd_dkv"] + ms["flash_bwd_dq"])
          / library_ms, **rows})
    return rows


def flash_bwd_phase(fa):
    """K2/K3 against the plain backward at B=1 (T 512, 1000, causal or
    not, bf16 and f32), then at the elastic trainer's shape and the two
    train shapes (bf16, causal), where K1's forward is held against the
    plain one too; at the train shapes each kernel is also timed alone (:func:`fwd_timing`,
    :func:`bwd_timing`).  Returns the
    K2/K3 timing rows at B=8 x T=1024, each one's max abs error there,
    and K1's timing rows by (B, T)."""
    gen = torch.Generator("cuda").manual_seed(5)
    h, d = 16, 128
    fwd_rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        for t in (512, 1000):
            for causal in (True, False):
                bwd_check(fa, bwd_inputs(gen, 1, t, h, d, dtype, causal),
                          {"phase": "flash_bwd",
                           "dtype": str(dtype).split(".")[1], "B": 1, "T": t,
                           "H": h, "D": d, "causal": causal})
    # the elastic trainer's shape, B=8 x T=128: one tile of a sequence,
    # held but not timed (its step is host-bound)
    args = bwd_inputs(gen, TRAIN_B, ELASTIC_T, h, d, torch.bfloat16, True)
    fwd_mx, fwd_mean = fwd_check(fa, *args[:4])
    bwd_check(fa, args, {"phase": "flash_bwd", "dtype": "bfloat16",
                         "B": TRAIN_B, "T": ELASTIC_T, "H": h, "D": d,
                         "causal": True, "fwd_max_abs_err": fwd_mx,
                         "fwd_mean_abs_err": fwd_mean})
    del args
    # the train step's shapes: B=1 x T=8192 and B=8 x T=1024 (the plain
    # versions' T x T f32 tensors, ~4.3 GB each at T=8192, fit on the card)
    for b, t in ((1, LONG_T), (TRAIN_B, TRAIN_T)):
        args = bwd_inputs(gen, b, t, h, d, torch.bfloat16, True)
        fwd_mx, fwd_mean = fwd_check(fa, *args[:4])
        main = bwd_check(fa, args,
                         {"phase": "flash_bwd", "dtype": "bfloat16", "B": b,
                          "T": t, "H": h, "D": d, "causal": True,
                          "fwd_max_abs_err": fwd_mx,
                          "fwd_mean_abs_err": fwd_mean})
        torch.cuda.empty_cache()
        fwd_rows[(b, t)] = fwd_timing(fa, *args[:3], b, t, h, d)
        torch.cuda.empty_cache()
        rows = bwd_timing(fa, args, b, t, h, d)
        del args
        torch.cuda.empty_cache()
    errs = {"flash_bwd_dkv": max(main["dk_max_abs_err"],
                                 main["dv_max_abs_err"]),
            "flash_bwd_dq": main["dq_max_abs_err"]}
    return rows, errs, fwd_rows


# ---------------------------------------------------------------------------
# phase 4: K4
# ---------------------------------------------------------------------------

def paged_case(pa, gen, *, dtype, s_w, lengths, w, b=8, h=16, d=128, bs=16,
               phase="paged"):
    n_blocks = b * w
    kp = torch.randn((n_blocks, bs, h, d), generator=gen,
                     device="cuda").to(dtype)
    vp = torch.randn((n_blocks, bs, h, d), generator=gen,
                     device="cuda").to(dtype)
    perm = torch.randperm(n_blocks, generator=gen, device="cuda")
    tables = perm.reshape(b, w).to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = torch.randn((b, s_w, h, d), generator=gen, device="cuda").to(dtype)
    got = pa.paged_attention(q, kp, vp, tables, lens)
    again = pa.paged_attention(q, kp, vp, tables, lens)
    want = pa.paged_attention(q, kp, vp, tables, lens, impl="torch")
    torch.cuda.synchronize()
    same = torch.equal(got, again)
    check(same, f"paged {dtype} S={s_w}: two launches differ")
    mx, mean = errors(got, want)
    if dtype == torch.bfloat16:
        check(mx <= BF16_TOL[0] and mean <= BF16_TOL[1],
              f"paged bf16 S={s_w}: {mx} {mean}")
    else:
        check(mx <= F32_TOL, f"paged f32 S={s_w}: {mx}")
    # yardstick: SDPA over the same context gathered dense beforehand
    # (the gather is not timed; the port never calls SDPA)
    kd = kp[tables.long()].reshape(b, w * bs, h, d).transpose(1, 2).contiguous()
    vd = vp[tables.long()].reshape(b, w * bs, h, d).transpose(1, 2).contiguous()
    qd = q.transpose(1, 2).contiguous()
    pos = torch.arange(w * bs, device="cuda")
    mask = (pos[None, None, :] <= (lens.long()[:, None]
                                   + torch.arange(s_w, device="cuda"))[:, :, None])
    mask = mask[:, None]
    visible = sum(min(n + s_w, w * bs) for n in lengths)
    el = q.element_size()
    nbytes = (2 * visible * h * d * el + 2 * q.numel() * el
              + tables.numel() * 4 + lens.numel() * 4)
    flops = sum(4.0 * h * d * sum(min(n + s + 1, w * bs) for s in range(s_w))
                for n in lengths)
    bnd, by = bound_ms(flops, nbytes, dtype)
    row = {
        "phase": phase, "dtype": str(dtype).split(".")[1], "B": b,
        "S": s_w, "H": h, "D": d, "block_size": bs, "W": w,
        "lengths": list(lengths), "max_abs_err": mx, "mean_abs_err": mean,
        "bit_identical": same,
        "ms": time_ms(lambda: pa.paged_attention(q, kp, vp, tables, lens),
                      iters=50),
        "plain_ms": time_ms(lambda: pa.paged_attention(
            q, kp, vp, tables, lens, impl="torch"), iters=10),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask), iters=50),
        "bound_ms": bnd, "bound_by": by,
    }
    emit(row)
    return row


def paged_phase(pa, prompt_lens):
    gen = torch.Generator("cuda").manual_seed(2)
    worst = 0.0
    w = 64
    for dtype, s_w in ((torch.bfloat16, 1), (torch.bfloat16, 4),
                       (torch.float32, 4)):
        row = paged_case(pa, gen, dtype=dtype, s_w=s_w, w=w,
                         lengths=[1, 15, 16, 17, 100, 333, 511, w * 16 - s_w])
        worst = max(worst, row["max_abs_err"])
    # the engine's shapes mid-generation: the 8 prompts 16 tokens in,
    # tables as wide as the longest request's reservation
    main = paged_case(pa, gen, dtype=torch.bfloat16, s_w=1,
                      lengths=[n + 16 for n in prompt_lens],
                      w=math.ceil((max(prompt_lens) + 32 + 3) / 16))
    worst = max(worst, main["max_abs_err"])
    return main, worst


# ---------------------------------------------------------------------------
# phase 5: the slice
# ---------------------------------------------------------------------------

def _site_stats(tele):
    return {name: site.stats()
            for name, site in tele.compute.sites().items()}


def post_prompts(url, prompts, max_tokens):
    """POST every prompt to ``url``'s /generate at once (one client thread
    each) and check that each answer is 200 with ``max_tokens`` tokens;
    returns ``(results, wall seconds, time.time() of the first 200)``
    with ``results`` the ``(status, document)`` of each prompt."""
    results = [None] * len(prompts)
    first = []

    def post(i, prompt):
        body = json.dumps({"prompt": prompt,
                           "max_tokens": max_tokens}).encode()
        req = urllib.request.Request(url + "/generate", data=body,
                                     headers={"Content-Type":
                                              "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                results[i] = (r.status, json.loads(r.read()))
                first.append(time.time())
        except (OSError, ValueError) as e:   # HTTPError is an OSError
            results[i] = (None, repr(e))

    t0 = time.perf_counter()
    clients = [threading.Thread(target=post, args=(i, p))
               for i, p in enumerate(prompts)]
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=600)
    wall = time.perf_counter() - t0
    for code, doc in results:
        check(code == 200, f"/generate answered {code}: {doc}")
        check(doc["state"] == "done" and doc["n_generated"] == max_tokens,
              f"request {doc['id']}: {doc['state']} {doc['n_generated']}")
    return results, wall, min(first)


def slice_prompts(vocab, prompt_lens):
    """The slice phase's prompts from seed 0: random ids of each length,
    and looping ones (a 7-token cycle) for speculative decoding."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, n).tolist() for n in prompt_lens]
    loop = rng.integers(0, vocab, 7).tolist()
    return prompts, [(loop * (n // 7 + 1))[:n] for n in prompt_lens]


def serve_batch(serving, model, prompts, spec_k):
    """Start an engine and its HTTP server on the card, POST every prompt
    to /generate at once (one client thread each), and check that each
    answer is 200 with 32 tokens.  Then the compute ledger: ``GET
    /compute`` and the decode records (the step ledger is reset first).
    Gates: the memory sample is the card's, no cost pass failed, every
    decode record has ``membw_util`` and ``bound``, the decode site's
    counted bytes are at least the bytes of the weights a step
    multiplies by, and for a dense model its counted FLOPs are within
    10% of the step's ``decode_flops_per_token`` sum.  The outputs go
    back under ``outputs`` (not emitted)."""
    from dmlc_tpu_torch import telemetry as tele

    tele.reset_steps()
    before = _site_stats(tele)
    eng = serving.InferenceEngine(model, device="cuda", n_blocks=256,
                                  block_size=16, max_active=8,
                                  queue_depth=64, spec_k=spec_k)
    eng.start()
    srv = serving.ServingHTTPServer(eng)
    try:
        results, wall, _ = post_prompts(srv.url, prompts, 32)
        ttft = sorted(doc["ttft_s"] for _, doc in results)
        tokens = sum(doc["n_generated"] for _, doc in results)
        code, comp = http(srv.url + "/compute")
        check(code == 200, f"/compute answered {code}")
        recs = tele.ledger().records()
        reqs = eng.requests.summary()
        cost = eng._decode.stats()
        out = {"requests": len(prompts), "spec_k": spec_k, "wall_s": wall,
               "tokens": tokens, "tokens_per_s": tokens / wall,
               "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
               "ttft_p99_s": pctl(ttft, 99),
               "step_p50_s": pctl([r["wall_s"] for r in recs], 50),
               "gap_p99_s": reqs["tbt_p99_s"],
               "compute": compute_doc(model, comp, recs, cost, before,
                                      eng._decode.site),
               **eng.stats()["counters"]}
        out["outputs"] = [doc["output_ids"] for _, doc in results]
        return out
    finally:
        srv.close()
        eng.close()


def compute_doc(model, comp, recs, cost, before, decode_site):
    """The serving gates on ``GET /compute`` and the decode records (see
    :func:`serve_batch`), and what they read: the bound verdicts, the
    phase shares, each site's cost passes (traces) in this phase with
    their seconds and its signatures, the decode step's counted bytes
    over its weights' bytes and counted over formula FLOPs."""
    check(comp["hbm"]["source"] == "device", f"hbm: {comp['hbm']}")
    check(comp["aot_fallbacks_total"] == 0,
          f"cost passes failed: {comp['aot_fallbacks_total']}")
    check(recs and all(r["membw_util"] is not None and r["bound"]
                       for r in recs),
          f"decode records without a roofline: {recs[:1]}")
    last = cost["last_cost"]
    check(last is not None, f"{decode_site}: no cost")
    weights = sum(p.numel() * p.element_size()
                  for name, p in model.named_parameters() if name != "embed")
    flops_ratio = last["flops"] / recs[-1]["flops"]
    if not model.cfg.routed:
        # the routed formula counts every expert (ROADMAP Queue 3, PR 10)
        check(abs(flops_ratio - 1) <= 0.10,
              f"{decode_site}: counted FLOPs {last['flops']} vs formula "
              f"{recs[-1]['flops']}")
    check(last["bytes_accessed"] >= weights,
          f"{decode_site}: counted bytes {last['bytes_accessed']} < "
          f"weights {weights}")
    bounds = {}
    for r in recs:
        bounds[r["bound"]] = bounds.get(r["bound"], 0) + 1
    passes = {}
    for name, st in comp["sites"].items():
        b0 = before.get(name, {"traces": 0, "compile_secs_total": 0.0})
        if st["traces"] > b0["traces"]:
            passes[name] = {
                "cost_passes": st["traces"] - b0["traces"],
                "seconds": st["compile_secs_total"]
                - b0["compile_secs_total"],
                "signatures": st["signatures"]}
    return {"decode_site": decode_site, "bound_verdicts": bounds,
            "membw_util_p50": pctl([r["membw_util"] for r in recs], 50),
            "mfu_p50": pctl([r["mfu"] for r in recs], 50),
            "phase_shares": comp["phases"]["shares"],
            "cost_passes": passes,
            "decode_signatures": cost["signatures"],
            "decode_bytes": last["bytes_accessed"],
            "decode_bytes_over_weights": last["bytes_accessed"] / weights,
            "decode_flops_counted_over_formula": flops_ratio,
            "hbm_peak_bytes": comp["hbm"]["peak_bytes"],
            "aot_fallbacks_total": comp["aot_fallbacks_total"]}


def _emitted(doc):
    return {k: v for k, v in doc.items() if k != "outputs"}


def http(url, doc=None, timeout=600):
    """``(status, body)`` of a GET (``doc`` None) or a JSON POST; a JSON
    body is decoded, any other is text."""
    data = None if doc is None else json.dumps(doc).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            code, body, ctype = r.status, r.read(), r.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        code, body, ctype = e.code, e.read(), e.headers["Content-Type"]
    return code, (json.loads(body) if ctype == "application/json"
                  else body.decode())


def pctl(xs, q):
    """Nearest-rank percentile (the ledgers' convention)."""
    xs = sorted(xs)
    return xs[min(int(q / 100 * len(xs)), len(xs) - 1)]


def ledger_cost(tele, n=400):
    """Host microseconds of the ledger's own work per step on the card:
    ``n`` empty steps (begin event, end event and its wait, the span
    walk over two spans, the record and the registry mirror) through a
    ledger of their own, then the per-step request-ledger work of a
    batch of 8 (8 token bursts and one iteration record)."""
    led = tele.StepLedger()
    led.declare_dtype("bfloat16")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        led.step_begin()
        with tele.span("feed.wait", stage="feed"):
            pass
        with tele.span("serving.prefill", stage="serving"):
            pass
        led.step_end(tokens=8.0, flops=1e12, tokens_per_step=1.0)
    step_us = (time.perf_counter() - t0) / n * 1e6
    reqs = tele.RequestLedger(slo=tele.SLOMonitor(), trace_rows=True)
    for i in range(8):
        reqs.on_submit(i, 100)
        reqs.on_prefill_begin(i)
        reqs.on_first_token(i)
    kv = {"blocks_in_use": 10, "n_blocks": 256, "occupancy": 0.04,
          "waste_tokens": 3, "cached_tokens": 157}
    t0 = time.perf_counter()
    for _ in range(n):
        now = time.perf_counter()
        for i in range(8):
            reqs.on_token(i, t=now)
        reqs.on_iteration(active=8, waiting=0, tokens=8, kv_stats=kv)
    return {"ledger_step_us": step_us,
            "request_ledger_step_us": (time.perf_counter() - t0) / n * 1e6}


def telemetry_serving(serving, tele, fa, model, cfg):
    """The port's load generator against the port's server, then the
    serving telemetry gates (see the module docstring)."""
    from dmlc_tpu_torch.telemetry.exporters import validate_exposition_text

    tele.reset()
    tele.reset_steps()
    tele.reset_events()
    eng = serving.InferenceEngine(model, device="cuda", n_blocks=256,
                                  block_size=16, max_active=8,
                                  queue_depth=64, spec_k=3)
    eng.start()
    srv = serving.ServingHTTPServer(eng)
    try:
        gen = serving.LoadGenerator(srv.url, n_streams=8,
                                    requests_per_stream=2,
                                    prompt_len=(17, 511), max_tokens=32,
                                    vocab=cfg.vocab, seed=0)
        load = gen.run()
        check(load["n_requests_ok"] == 16 and not gen.failures,
              f"loadgen: {load} {gen.failures[:2]}")
        _, text = http(srv.url + "/metrics")
        samples = validate_exposition_text(text)
        _, reqs = http(srv.url + "/requests")
        recent = reqs["recent"]
        check(reqs["summary"]["requests_done"] == 16 and len(recent) == 16
              and len({r["id"] for r in recent}) == 16
              and all(r["state"] == "done" and r["n_generated"] == 32
                      for r in recent),
              f"/requests: {reqs['summary']}")
        steps = tele.ledger().records()
        led = tele.ledger().summary()
        check(led["mfu"] is not None, "decode MFU unreported")
        _, comp = http(srv.url + "/compute")
        # a duplicate request_id: the original's tokens, no second prefill
        doc = {"prompt": list(range(1, 200)), "max_tokens": 32,
               "request_id": "smoke-dedupe"}
        code1, first = http(srv.url + "/generate", doc)
        k1 = fa.FLASH_FWD.launches
        code2, again = http(srv.url + "/generate", doc)
        check(code1 == code2 == 200 and again["id"] == first["id"]
              and again["output_ids"] == first["output_ids"]
              and fa.FLASH_FWD.launches == k1,
              f"dedupe: {code1} {code2}, K1 {k1} -> "
              f"{fa.FLASH_FWD.launches}")
        # a drain started during a request finishes it; the next POST 503s
        inflight = {}
        t = threading.Thread(target=lambda: inflight.setdefault(
            "r", http(srv.url + "/generate", {"prompt": [5] * 64,
                                              "max_tokens": 256})))
        t.start()
        deadline = time.monotonic() + 300
        while eng.scheduler.counts()[0] < 1:
            check(time.monotonic() < deadline, "drain: never active")
            time.sleep(0.005)
        eng.begin_drain()
        code3, refused = http(srv.url + "/generate",
                              {"prompt": [1, 2], "max_tokens": 2})
        clean = srv.drain(timeout_s=300)
        t.join(timeout=300)
        code4, done = inflight["r"]
        check(code3 == 503 and clean and code4 == 200
              and done["n_generated"] == 256,
              f"drain: POST {code3}, clean {clean}, in-flight {code4}")
    finally:
        srv.close()
        eng.close()
    walls = [r["wall_s"] for r in steps]
    issue = [r["host_issue_s"] for r in steps]
    check(comp["hbm"]["source"] == "device"
          and comp["aot_fallbacks_total"] == 0
          and all(r["membw_util"] is not None and r["bound"] for r in steps),
          f"/compute: {comp['hbm']['source']}, "
          f"{comp['aot_fallbacks_total']} failed cost passes")
    return {
        "requests": 16, "streams": 8, "spec_k": 3,
        "compute": {name: {k: st[k] for k in ("traces", "hits",
                                              "signatures",
                                              "compile_secs_total")}
                    for name, st in comp["sites"].items()
                    if name.startswith("serving.")},
        "loadgen": {k: load[k] for k in (
            "wall_s", "total_generated_tokens", "aggregate_tokens_per_s",
            "p50_ttft_s", "p99_ttft_s", "p50_latency_s",
            "tokens_per_s_per_user", "client_server_delta_p99_s")},
        "requests_summary": reqs["summary"],
        "gap_p99_s": reqs["summary"]["tbt_p99_s"],
        "decode_steps": len(steps),
        "decode_wall_p50_s": pctl(walls, 50),
        "decode_wall_p99_s": pctl(walls, 99),
        "decode_host_issue_p50_s": pctl(issue, 50),
        "decode_host_issue_p99_s": pctl(issue, 99),
        "decode_mfu": led["mfu"],
        "tokens_per_step": led["tokens_per_step"],
        "spec_accept_rate": led["spec_accept_rate"],
        "metrics_samples": samples,
        "dedupe_same_tokens_no_prefill": True,
        "drain": {"refused": code3, "clean": clean,
                  "inflight_tokens": done["n_generated"]},
        **ledger_cost(tele)}


def slice_inputs(cfg, device="cuda"):
    """Inputs of one prefill (T=512) and one decode step (B=8, every row
    on the prefilled context, lengths 17..511) at flagship shapes."""
    gen = torch.Generator(device).manual_seed(3)
    t, b, w = 512, 8, 40
    return {
        "ids": torch.randint(0, cfg.vocab, (1, t), generator=gen,
                             device=device),
        "dids": torch.randint(0, cfg.vocab, (b, 1), generator=gen,
                              device=device),
        "lengths": torch.tensor([17, 64, 100, 200, 255, 300, 400, 511],
                                dtype=torch.int32, device=device),
        "tables": torch.arange(b * w, device=device, dtype=torch.int32
                               ).reshape(b, w),
    }


def prefill(tfm, model, inp, impl=None, **shard):
    """One prefill of ``inp``'s ids (``shard``: ``axes`` and ``mesh``)."""
    ids = inp["ids"]
    with torch.inference_mode():
        return tfm.forward_prefill_last(
            model, ids, torch.tensor([ids.shape[1] - 1], device=ids.device),
            impl=impl, **shard)


def decode_pools(k, v, inp, bs=16):
    """Pools where every decode row holds the prefilled context ``k``/``v``
    ``[L, 1, T, H, D]`` (``H`` the heads the caller holds)."""
    b, w = inp["tables"].shape
    shape = (k.shape[0], b * w, bs, k.shape[3], k.shape[4])
    kp = torch.zeros(shape, dtype=k.dtype, device=k.device)
    vp = torch.zeros_like(kp)
    n = k.shape[2] // bs
    for i in range(b):
        kp[:, i * w:i * w + n] = k[:, 0].reshape(shape[0], n, *shape[2:])
        vp[:, i * w:i * w + n] = v[:, 0].reshape(shape[0], n, *shape[2:])
    return kp, vp


def decode(tfm, model, inp, kp, vp, impl=None, **shard):
    with torch.inference_mode():
        return tfm.forward_decode_paged(
            model, inp["dids"], inp["lengths"].long()[:, None], kp, vp,
            inp["tables"], inp["lengths"], impl=impl, **shard)


def slice_logits(tfm, model, cfg):
    """One prefill and one decode step through the kernels and through
    the plain versions: ``{impl: (prefill logits, decode logits)}``."""
    inp = slice_inputs(cfg)
    out = {}
    for impl in (None, "torch"):
        lp, k, v = prefill(tfm, model, inp, impl)
        kp, vp = decode_pools(k, v, inp)
        out[impl] = (lp.float(), decode(tfm, model, inp, kp, vp, impl).float())
    check(all(bool(torch.isfinite(x).all()) for x in out[None]),
          "non-finite logits")
    return out


def _category(name):
    low = name.lower()
    for kernel, cat in (("flash_fwd_kernel", "flash_fwd"),
                        ("flash_bwd_dkv_kernel", "flash_bwd_dkv"),
                        ("flash_bwd_dq_kernel", "flash_bwd_dq"),
                        ("paged_split_kernel", "paged_attention"),
                        ("paged_combine_kernel", "paged_attention")):
        if kernel in low:
            return cat
    if "multi_tensor_apply" in low or "adam" in low:
        return "optimizer"
    if any(s in low for s in ("gemm", "cutlass", "nvjet", "xmma", "cublas")):
        return "gemm"
    if "memcpy" in low or "memset" in low:
        return "memcpy"
    return "other"


def profile_phase(tfm, model, cfg, train_steps):
    """Device time by kernel category for one flagship prefill (T=512),
    one decode step (B=8) and the train steps in ``train_steps`` (name
    -> step), beside the step's wall time (host clock around a
    synchronised call, profiler off); idle = 1 - busy / wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    inp = slice_inputs(cfg)
    _, k, v = prefill(tfm, model, inp)
    kp, vp = decode_pools(k, v, inp)
    steps = {"prefill": lambda: prefill(tfm, model, inp),
             "decode": lambda: decode(tfm, model, inp, kp, vp),
             **train_steps}
    doc = {"phase": "profile"}
    for name, fn in steps.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        cats, kernels = {}, []
        for e in prof.key_averages():
            # a user annotation (the optimizer's record_function range)
            # spans kernels already counted; its time is not added again
            if (e.device_type == DeviceType.CUDA and e.self_device_time_total
                    and not getattr(e, "is_user_annotation", False)):
                c = _category(e.key)
                cats[c] = cats.get(c, 0.0) + e.self_device_time_total / 1e3
                kernels.append((e.self_device_time_total / 1e3, e.count,
                                e.key[:100]))
        wall_ms = sorted(walls)[len(walls) // 2] * 1e3
        busy = sum(cats.values())
        host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                       for e in prof.key_averages()
                       if e.key.startswith("aten::")), reverse=True)[:8]
        doc[name] = {"wall_ms": wall_ms, "device_ms": cats,
                     "device_busy_ms": busy,
                     "idle_share": (1 - busy / wall_ms) if busy else None,
                     "device_top_ms_calls": [[k, ms, n] for ms, n, k in
                                             sorted(kernels)[::-1][:12]],
                     "host_top_ms_calls": [[k, ms, n] for ms, n, k in host]}
    return doc


def rel_err(a, b):
    return ((a - b).abs().max() / b.std()).item()


def logit_checks(tfm, model, cfg):
    """The kernel path against the plain path end to end.  Gated on a
    float32 copy of the flagship: in bf16 the random-weight model
    amplifies single-ulp rounding differences through 16 layers, so the
    bf16 numbers are reported beside that model's own bf16 noise floor
    (plain bf16 against plain float32)."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = tfm.Transformer(cfg32, device="cuda")
    with torch.no_grad():
        for p32, p in zip(m32.parameters(), model.parameters()):
            p32.copy_(p.float())
    r16 = slice_logits(tfm, model, cfg)
    r32 = slice_logits(tfm, m32, cfg32)
    del m32
    doc = {"phase": "slice_logits", "prefill_T": 512, "decode_B": 8}
    for i, name in enumerate(("prefill", "decode")):
        doc[f"{name}_rel_err_f32"] = rel_err(r32[None][i], r32["torch"][i])
        doc[f"{name}_rel_err_bf16"] = rel_err(r16[None][i], r16["torch"][i])
        doc[f"{name}_bf16_noise_floor"] = rel_err(r16["torch"][i],
                                                  r32["torch"][i])
        check(doc[f"{name}_rel_err_f32"] <= LOGIT_TOL,
              f"{name} logits rel err {doc[f'{name}_rel_err_f32']}")
    return doc


def _serve_off(serving, model, prompts, spec_k):
    """:func:`serve_batch` with ``DMLC_SERVE_PAGED_ATTN=off`` (the gather
    path)."""
    os.environ["DMLC_SERVE_PAGED_ATTN"] = "off"
    try:
        return serve_batch(serving, model, prompts, spec_k)
    finally:
        del os.environ["DMLC_SERVE_PAGED_ATTN"]


def _agreement(a, b):
    """Token streams of the same prompts on two paths: requests equal,
    and the mean share of each stream before its first difference."""
    prefix = []
    for x, y in zip(a, b):
        n = next((i for i, (p, q) in enumerate(zip(x, y)) if p != q),
                 len(x))
        prefix.append(n / len(x))
    return {"requests_equal": sum(x == y for x, y in zip(a, b)),
            "requests": len(a), "mean_prefix_share": sum(prefix) / len(a)}


def gather_phase(serving, fa, pa, tfm, model, prompts, looping, paged):
    """The gather decode path (``DMLC_SERVE_PAGED_ATTN=off``): the
    flagship served as the slice phase serves it (8 requests at spec_k 0,
    8 looping ones at spec_k 3), K1 and K4 counted from 0 just before: K1
    launches equal the paged run's (the same prefills), K4 none.  The
    bf16 token streams are held beside the paged run's (reported: the
    two paths round differently).  Then a float32 copy at depth 2 served
    both ways on the same prompts: equal greedy tokens; and one decode
    step of it (B=8, contexts 17..511) through ``forward_decode_paged``
    and through ``gather`` + ``forward_decode``: logits within 1e-4
    relative (max abs difference over max abs logit)."""
    fa.FLASH_FWD.launches = 0
    pa.PAGED_ATTENTION.launches = 0
    plain = _serve_off(serving, model, prompts, 0)
    spec = _serve_off(serving, model, looping, 3)
    launches = {"flash_fwd": fa.FLASH_FWD.launches,
                "paged_attention": pa.PAGED_ATTENTION.launches}
    cfg = model.cfg
    check(launches["paged_attention"] == 0
          and launches["flash_fwd"] == paged["flash_fwd"]
          == cfg.n_layers * (plain["prefills"] + spec["prefills"]),
          f"gather launches {launches}, paged {paged}")
    doc = {"phase": "gather", "model": "flagship", "launches": launches,
           "paged_launches": {k: paged[k] for k in launches},
           "plain": _emitted(plain), "spec": _emitted(spec),
           "bf16_vs_paged": {
               "spec_0": _agreement(plain["outputs"],
                                    paged["outputs"][0]),
               "spec_3": _agreement(spec["outputs"], paged["outputs"][1])},
           "step_p50_s": {"paged": [d["step_p50_s"]
                                    for d in paged["docs"]],
                          "gather": [plain["step_p50_s"],
                                     spec["step_p50_s"]]},
           "gap_p99_s": {"paged": [d["gap_p99_s"] for d in paged["docs"]],
                         "gather": [plain["gap_p99_s"],
                                    spec["gap_p99_s"]]}}
    # the float32 depth-2 copy, both paths
    cfg2 = dataclasses.replace(cfg, dtype="float32", n_layers=2)
    m2 = tfm.Transformer(cfg2, device="cuda")
    with torch.no_grad():
        want = dict(model.named_parameters())
        for name, p in m2.named_parameters():
            p.copy_(want[name].float())
    f32 = {}
    for mode, run in (("paged", serve_batch), ("gather", _serve_off)):
        f32[mode] = [run(serving, m2, prompts, 0)["outputs"],
                     run(serving, m2, looping, 3)["outputs"]]
    check(f32["paged"] == f32["gather"],
          f"f32 tokens differ between the paths: "
          f"{_agreement(f32['paged'][0], f32['gather'][0])}")
    inp = slice_inputs(cfg2)
    _, k, v = prefill(tfm, m2, inp)
    kp, vp = decode_pools(k, v, inp)
    b, w = inp["tables"].shape
    with torch.inference_mode():
        got = decode(tfm, m2, inp, kp.clone(), vp.clone())[:, 0]
        kd, vd = (x[:, inp["tables"].long()].reshape(
            cfg2.n_layers, b, w * 16, cfg2.n_heads, cfg2.head_dim)
            for x in (kp, vp))
        lens = inp["lengths"]
        dense = tfm.forward_decode(m2, inp["dids"][:, 0], lens.long(), kd,
                                   vd, lens)[0]
    rel = ((got - dense).abs().max() / dense.abs().max()).item()
    check(rel <= 1e-4, f"paged vs gather decode logits rel {rel}")
    doc["f32_depth2"] = {"tokens_equal": True,
                         "decode_logits_rel": rel,
                         "requests": 2 * len(prompts)}
    del m2, kp, vp, kd, vd
    return doc, launches


# ---------------------------------------------------------------------------
# phase 6: training
# ---------------------------------------------------------------------------

def train_batch(cfg, b, t, seed):
    """Random ids from a seeded generator, labels the ids shifted by one
    (as bench.py's train benchmark)."""
    gen = torch.Generator("cuda").manual_seed(seed)
    ids = torch.randint(0, cfg.vocab, (b, t), generator=gen, device="cuda")
    return ids, ids.roll(-1, 1)


def train_stats(tfm, cfg, b, t, walls):
    wall = sorted(walls)[len(walls) // 2]
    tok_s = b * t / wall
    return {"step_ms_p50": wall * 1e3, "step_ms": [w * 1e3 for w in walls],
            "tokens_per_s": tok_s,
            # against the H100 SXM's dense bf16 peak (989 TFLOP/s)
            "mfu": (tfm.train_flops_per_token(cfg, t) * tok_s
                    / PEAK_FLOPS[torch.bfloat16]),
            "peak_bytes": torch.cuda.max_memory_allocated()}


def timed_steps(step, ids, labels, n, kernels=()):
    """``n`` synchronised steps: (wall seconds, losses, launches of each
    kernel in each step)."""
    walls, losses, launches = [], [], []
    for _ in range(n):
        before = [kern.launches for kern in kernels]
        t0 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(loss.item())
        launches.append([kern.launches - n0
                         for kern, n0 in zip(kernels, before)])
    return walls, losses, launches


def ledger_pairs(step, bare, ids, labels, pairs=12):
    """``pairs`` pairs of a ledgered and a bare step on one model, in ABBA
    order, each a host wall ended by ``torch.cuda.synchronize()``: the
    ledgered minus the bare wall per pair, in ms."""
    walls = {True: [], False: []}
    for i in range(2 * pairs):
        ledgered = i % 4 in (0, 3)
        t0 = time.perf_counter()
        (step if ledgered else bare)(ids, labels)
        torch.cuda.synchronize()
        walls[ledgered].append(time.perf_counter() - t0)
    diffs = [(a - b) * 1e3 for a, b in zip(walls[True], walls[False])]
    return {"pairs": pairs, "ledgered_ms_p50": median(walls[True]) * 1e3,
            "bare_ms_p50": median(walls[False]) * 1e3,
            "diff_ms_p50": median(diffs), "diff_ms_min": min(diffs),
            "diff_ms_max": max(diffs),
            "ledgered_slower": sum(d > 0 for d in diffs),
            "diff_ms": diffs}


def memory_sample_ms(step, ids, labels, tele, n=6):
    """``n`` steps, each followed by one timed ``mem_get_info`` (the
    driver call a memory sample makes once a card) and one timed
    ``compute.sample_hbm`` (what the train step runs after each step,
    outside the ledger's wall), in ms."""
    got = {"mem_get_info_ms": [], "sample_hbm_ms": []}
    for _ in range(n):
        step(ids, labels)
        torch.cuda.synchronize()
        for key, fn in (("mem_get_info_ms",
                         lambda: torch.cuda.mem_get_info(0)),
                        ("sample_hbm_ms", tele.compute.sample_hbm)):
            t0 = time.perf_counter()
            fn()
            got[key].append((time.perf_counter() - t0) * 1e3)
    return got


def train_phase(tfm, fa, tele, cfg):
    """The flagship train step at B=8 x T=1024: 2 warm-up steps, then the
    counters are zeroed and 8 steps timed on the same batch, all through
    the step ledger (reset first: the serving phases declared decode
    FLOPs), then 12 ABBA pairs of ledgered against bare steps, then 6
    bare steps each followed by a timed memory sample."""
    tele.reset_steps()
    model = tfm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            "cuda")
    opt = tfm.adamw(model.parameters(), 1e-4)
    step = tfm.make_train_step(model, opt)
    ids, labels = train_batch(cfg, TRAIN_B, TRAIN_T, 1)
    torch.cuda.reset_peak_memory_stats()
    _, warm, _ = timed_steps(step, ids, labels, 2)
    # the first step was the site's cost pass: forward, backward, update
    site = tele.compute.sites()["train.step"].stats()
    cost = site["last_cost"]
    check(cost is not None and site["aot_fallbacks"] == 0
          and site["traces"] == 1, f"train.step: {site}")
    counted = cost["flops"] / tfm.train_step_flops(cfg, TRAIN_B, TRAIN_T)
    check(counted > 1.0, f"train step counted FLOPs {cost['flops']} under "
          f"train_step_flops: the backward went uncounted")
    kernels = {"flash_fwd": fa.FLASH_FWD, "flash_bwd_dkv": fa.FLASH_BWD_DKV,
               "flash_bwd_dq": fa.FLASH_BWD_DQ}
    for kern in kernels.values():
        kern.launches = 0
    walls, losses, per_step = timed_steps(step, ids, labels, 8,
                                          tuple(kernels.values()))
    launches = {name: kern.launches for name, kern in kernels.items()}
    recs = tele.ledger().records()[-8:]
    peak = tele.ledger().peak_flops()
    check(len(recs) == 8 and peak == PEAK_FLOPS[torch.bfloat16]
          and all(r["mfu"] is not None for r in recs),
          f"ledger: {len(recs)} records, peak {peak}")
    ledger_mfu = sum(r["flops"] for r in recs) / sum(
        r["wall_s"] for r in recs) / peak
    own_mfu = (tfm.train_flops_per_token(cfg, TRAIN_T) * TRAIN_B * TRAIN_T
               * len(walls) / sum(walls) / PEAK_FLOPS[torch.bfloat16])
    check(abs(ledger_mfu / own_mfu - 1) <= 0.01,
          f"ledger MFU {ledger_mfu} vs the smoke's {own_mfu}")
    check(all(r["membw_util"] is not None and r["bound"] for r in recs),
          f"train records without a roofline: {recs[0]}")
    bare = tfm.make_train_step(model, opt, ledger=False)
    bare(ids, labels)   # its first step is its cost pass, outside the pairs
    TELEMETRY["train"] = {
        "B": TRAIN_B, "T": TRAIN_T, "steps": len(recs),
        "step_p50_s": pctl([r["wall_s"] for r in recs], 50),
        "step_p99_s": pctl([r["wall_s"] for r in recs], 99),
        "host_issue_p50_s": pctl([r["host_issue_s"] for r in recs], 50),
        "event_span_p50_s": pctl([r["event_span_s"] for r in recs], 50),
        "ledger_mfu": ledger_mfu, "smoke_mfu_same_steps": own_mfu,
        "mfu_rel_diff": ledger_mfu / own_mfu - 1,
        "compute": {
            "counted_flops": cost["flops"],
            "counted_over_train_step_flops": counted,
            "bytes_accessed": cost["bytes_accessed"],
            "cost_pass_s": site["compile_secs_total"],
            "membw_util_p50": pctl([r["membw_util"] for r in recs], 50),
            "bound": [r["bound"] for r in recs]},
        "ledger_vs_bare": ledger_pairs(step, bare, ids, labels),
        "memory_sample": memory_sample_ms(bare, ids, labels, tele)}
    losses = warm + losses
    check(all(math.isfinite(x) for x in losses), f"train losses {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    check(all(n == [cfg.n_layers] * 3 for n in per_step),
          f"launches per step {per_step}, want {cfg.n_layers} of each")
    emit({"phase": "train", "model": "flagship", "B": TRAIN_B,
          "T": TRAIN_T, "remat_policy": cfg.remat_policy, "lr": 1e-4,
          "losses": losses, "launches_per_step": dict(zip(kernels,
                                                          per_step[0])),
          **train_stats(tfm, cfg, TRAIN_B, TRAIN_T, walls)})
    emit({"phase": "launches_train", **launches})
    return model, (lambda: step(ids, labels)), launches, step


def train_long_phase(tfm, cfg, step):
    """Two steps at the reference's long-context shape, B=1 x T=8192,
    after one warm-up (the shape's first step is the site's cost
    pass)."""
    ids, labels = train_batch(cfg, 1, LONG_T, 2)
    timed_steps(step, ids, labels, 1)
    torch.cuda.reset_peak_memory_stats()
    walls, losses, _ = timed_steps(step, ids, labels, 2)
    check(all(math.isfinite(x) for x in losses), f"long losses {losses}")
    emit({"phase": "train_long", "B": 1, "T": LONG_T, "losses": losses,
          **train_stats(tfm, cfg, 1, LONG_T, walls)})
    return lambda: step(ids, labels)


def grad_checks(tfm, cfg):
    """Gradients of the loss through the kernels against the plain
    versions, on a float32 copy of the flagship at full width and depth
    2 (the plain attention's T x T tensors stay small), B=2, T=1024.  The
    bf16 copy is reported beside its own noise floor (plain bf16 against
    plain f32)."""
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    m32 = tfm.init_params(cfg32, torch.Generator("cuda").manual_seed(4),
                          "cuda")
    m16 = tfm.Transformer(dataclasses.replace(cfg32, dtype="bfloat16"),
                          device="cuda")
    with torch.no_grad():
        for p16, p32 in zip(m16.parameters(), m32.parameters()):
            p16.copy_(p32)
    ids, labels = train_batch(cfg, 2, TRAIN_T, 3)

    def grads(model, impl):
        model.zero_grad(set_to_none=True)
        tfm.unsharded_loss(model, ids, labels, impl=impl).backward()
        out = [p.grad.float() for p in model.parameters()]
        model.zero_grad(set_to_none=True)
        return out

    def worst(got, want):
        # a gradient that is exactly 0 on the plain path (the one-expert
        # gate) is held to 0 in absolute terms
        return max(rel_norm(g, w) if w.norm() > 0 else g.norm().item()
                   for g, w in zip(got, want))

    g32 = {impl: grads(m32, impl) for impl in (None, "torch")}
    g16 = {impl: grads(m16, impl) for impl in (None, "torch")}
    doc = {"phase": "train_grads", "n_layers": 2, "B": 2, "T": TRAIN_T,
           "rel_err_f32": worst(g32[None], g32["torch"]),
           "rel_err_bf16": worst(g16[None], g16["torch"]),
           "bf16_noise_floor": worst(g16["torch"], g32["torch"])}
    check(doc["rel_err_f32"] <= TRAIN_GRAD_TOL,
          f"train grads rel err {doc['rel_err_f32']}")
    return doc


# ---------------------------------------------------------------------------
# phase 7: the data spine
# ---------------------------------------------------------------------------

SPINE_T = 1024                  # tokens a record holds beyond the first
SPINE_REC = (SPINE_T + 1) * 4   # 4100 bytes a record
SPINE_PARTS, SPINE_PER_PART = 4, 2
SPINE_RECORDS = 512
FEED_SHARD_BYTES = 256 << 20
FEED_PER_PART = 384             # ~6.3 MB a feed-rate batch (4 parts)


def spine_tokens(n, vocab, seed):
    """``n`` records of SPINE_T + 1 int32 tokens, arithmetic sequences
    mod ``vocab`` (the JAX example's ``make_data`` at the flagship's
    vocab and T, drawn in one go)."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, vocab, n)[:, None]
    step = rng.integers(1, 7, n)[:, None]
    return ((start + step * np.arange(SPINE_T + 1)) % vocab).astype(np.int32)


def write_shard(path, toks):
    """One RecordIO shard, a record per row, through the port's writer."""
    from dmlc_tpu_torch.io.recordio import RecordIOWriter
    from dmlc_tpu_torch.io.stream import Stream

    with Stream.create(path, "w") as s:
        w = RecordIOWriter(s)
        for row in toks:
            w.write_record(row.tobytes())


def bits_equal(a, b):
    """Two checkpoint trees hold the same paths and the same bits."""
    from dmlc_tpu_torch.checkpoint.sharded import flatten_with_path

    fa, fb = flatten_with_path(a), flatten_with_path(b)
    if [p for p, _ in fa] != [p for p, _ in fb]:
        return False
    for (_, x), (_, y) in zip(fa, fb):
        x = torch.as_tensor(x).reshape(-1).view(torch.uint8)
        y = torch.as_tensor(y).reshape(-1).view(torch.uint8)
        if not torch.equal(x, y):
            return False
    return True


def spine_feed(uri):
    from dmlc_tpu_torch.feed import recordio_feed

    return recordio_feed(uri, batch_records=SPINE_PER_PART,
                         max_bytes=SPINE_REC, num_parts=SPINE_PARTS,
                         device="cuda")


def spine_step(step, it, inside=None):
    """One bare train step on the next feed batch, or on a batch already
    on the card when ``it`` is a pair ``(ids, labels)``, as one step of
    the process step ledger opened before the batch is pulled (so the
    feed's wait is the step's feed-wait), with ``inside()`` run after
    the train step and before the step closes: ``(batch, loss, seconds
    in next(), step wall)``.  ``ledger().records()[-1]`` is its record."""
    from dmlc_tpu_torch import telemetry as tele
    from dmlc_tpu_torch.examples import train_lm_recordio as ex

    t0 = time.perf_counter()
    tele.step_begin()
    batch = None if isinstance(it, tuple) else next(it)
    t1 = time.perf_counter()
    ids, labels = it if batch is None else ex.batch_tokens(batch)
    loss = step(ids, labels)
    if inside is not None:
        inside()
    tele.step_end(tokens=float(ids.numel()))
    torch.cuda.synchronize()
    return batch, loss.item(), t1 - t0, time.perf_counter() - t0


def spine_train(tfm, fa, cfg, uri, toks):
    """Train the flagship from the RecordIO shard through the feed: 2
    warm-up steps, then 24 fed steps each paired with a step on a batch
    already on the card, in ABBA order (launch counts zeroed before the
    timed ones), so the paired walls show what the feed's threads cost
    the step."""
    from dmlc_tpu_torch.examples import train_lm_recordio as ex
    from dmlc_tpu_torch.io import input_split

    # the records each partition starts with, from the split's spans
    split = input_split.create(uri, 0, 1, "recordio", threaded=False)
    first = [b // (SPINE_REC + 8)
             for b, _ in split.partition_spans(SPINE_PARTS)]
    split.close()
    want = torch.from_numpy(np.concatenate(
        [toks[i:i + SPINE_PER_PART] for i in first]).view(np.uint8)).cuda()
    resident = ex.batch_tokens({"data": torch.from_numpy(spine_tokens(
        SPINE_PARTS * SPINE_PER_PART, cfg.vocab, 2).view(np.uint8)).cuda()})

    from dmlc_tpu_torch import telemetry as tele

    model = tfm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            "cuda")
    opt = tfm.adamw(model.parameters(), 1e-4)
    # bare: spine_step brackets the ledger's step around the feed's wait
    step = tfm.make_train_step(model, opt, ledger=False)
    kernels = {"flash_fwd": fa.FLASH_FWD, "flash_bwd_dkv": fa.FLASH_BWD_DKV,
               "flash_bwd_dq": fa.FLASH_BWD_DQ}
    f = spine_feed(uri)
    it = iter(f)
    losses, walls, waits, res_walls, per_step = [], [], [], [], []
    fed_recs, fed_stats_wait = [], []
    try:
        for _ in range(2):
            batch, loss, _, _ = spine_step(step, it)
            if not losses:
                first_exact = (torch.equal(batch["data"], want) and bool(
                    (batch["length"] == SPINE_REC).all()))
                probe = ex.batch_tokens(batch)
            losses.append(loss)
        for kern in kernels.values():
            kern.launches = 0
        for i in range(48):
            fed = i % 4 in (0, 3)
            before = [k.launches for k in kernels.values()]
            wait0 = f.stats()["wait_s"]
            _, loss, wait, wall = spine_step(step, it if fed else resident)
            if fed:
                fed_recs.append(tele.ledger().records()[-1])
                fed_stats_wait.append(f.stats()["wait_s"] - wait0)
            per_step.append([k.launches - n0 for k, n0 in
                             zip(kernels.values(), before)])
            if not fed:
                res_walls.append(wall)
            else:
                losses.append(loss)
                walls.append(wall)
                waits.append(wait)
        launches = {n: k.launches for n, k in kernels.items()}
        # each step trains on new records, whose loss moves less than its
        # noise in 26 steps at lr 1e-4; the first batch's loss, taken
        # again after them, shows the updates landed
        with torch.no_grad():
            probe_loss = tfm.unsharded_loss(model, *probe).item()
        stats = f.stats()
    finally:
        f.close()
    check(first_exact, "spine: the first feed batch differs from the "
          "records as written")
    check(all(math.isfinite(x) for x in losses + [probe_loss]),
          f"spine losses {losses}, {probe_loss}")
    check(probe_loss < losses[0],
          f"spine: the first batch's loss did not fall: {losses[0]} -> "
          f"{probe_loss}")
    check(all(n == [cfg.n_layers] * 3 for n in per_step),
          f"spine launches per step {per_step}, want {cfg.n_layers} of each")
    ledger_wait = sum(r["feed_wait_s"] for r in fed_recs)
    feed_wait = sum(fed_stats_wait)
    ledger_wall = sum(r["wall_s"] for r in fed_recs)
    # the ledger bills the consumer's feed.wait span, which wraps the
    # block the feed's own wait clock times
    check(abs(ledger_wait - feed_wait) <= 1e-3 + 0.05 * feed_wait,
          f"spine: ledger feed wait {ledger_wait} s, the feed's {feed_wait}")
    TELEMETRY["spine"] = {
        "fed_steps": len(fed_recs),
        "ledger_feed_wait_share": ledger_wait / ledger_wall,
        "feed_own_wait_share": feed_wait / ledger_wall,
        "ledger_feed_wait_s": ledger_wait, "feed_own_wait_s": feed_wait,
        "ledger_fed_step_p50_s": pctl([r["wall_s"] for r in fed_recs], 50),
        "host_issue_p50_s": pctl([r["host_issue_s"] for r in fed_recs], 50)}
    diffs = [a - b for a, b in zip(walls, res_walls)]
    return {
        "phase": "spine_train", "model": "flagship",
        "feed": f"recordio_feed(num_parts={SPINE_PARTS}, "
                f"batch_records={SPINE_PER_PART}, max_bytes={SPINE_REC})",
        "B": SPINE_PARTS * SPINE_PER_PART, "T": SPINE_T, "lr": 1e-4,
        "first_batch_byte_exact": first_exact, "losses": losses,
        "first_batch_loss_after": probe_loss,
        "launches_per_step": dict(zip(kernels, per_step[0])),
        "launches": launches, "step_ms_p50": median(walls) * 1e3,
        "step_ms": [w * 1e3 for w in walls],
        "resident_step_ms_p50": median(res_walls) * 1e3,
        "resident_step_ms": [w * 1e3 for w in res_walls],
        "fed_minus_resident_ms_p50": median(diffs) * 1e3,
        "fed_minus_resident_ms": [d * 1e3 for d in diffs],
        "feed_wait_ms_p50": median(waits) * 1e3,
        "feed_wait_ms": [w * 1e3 for w in waits],
        "feed_wait_share": sum(waits) / sum(walls), "feed_stats": stats}


def median(xs):
    return sorted(xs)[len(xs) // 2]


def spine_checkpoint(tfm, cfg, uri, ckpt_dir):
    """Train a model at ``cfg`` 2 steps from the feed, checkpoint its
    full train state with the stream position, take 2 more steps, then
    restore into a fresh model and AdamW and take the same 2 steps from
    a feed fast-forwarded to the saved position."""
    from dmlc_tpu_torch import native
    from dmlc_tpu_torch.checkpoint import CheckpointManager
    from dmlc_tpu_torch.examples import train_lm_recordio as ex
    from dmlc_tpu_torch.models.convert import (train_state_from_jax,
                                               train_state_to_jax)

    from dmlc_tpu_torch import telemetry as tele

    model = tfm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            "cuda")
    opt = tfm.adamw(model.parameters(), 1e-4)
    step = tfm.make_train_step(model, opt, ledger=False)
    consumed = 2
    mgr = CheckpointManager(ckpt_dir, max_to_keep=1)
    held = {}

    def save_inside():
        """The checkpoint, made inside the second step."""
        t0 = time.perf_counter()
        held["saved"] = ex.train_state(model, opt, consumed)
        t1 = time.perf_counter()
        mgr.save(consumed, held["saved"])
        held["to_host_s"], held["save_s"] = t1 - t0, time.perf_counter() - t1

    f = spine_feed(uri)
    try:
        it = iter(f)
        for i in range(consumed):
            spine_step(step, it, save_inside if i == consumed - 1 else None)
        rec = tele.ledger().records()[-1]
        saved, to_host_s, save_s = (held["saved"], held["to_host_s"],
                                    held["save_s"])
        check(0 < rec["checkpoint_stall_s"] <= save_s,
              f"checkpoint stall {rec['checkpoint_stall_s']} s of a "
              f"{save_s} s save")
        TELEMETRY["checkpoint"] = {
            "n_layers": cfg.n_layers, "step_wall_s": rec["wall_s"],
            "checkpoint_stall_s": rec["checkpoint_stall_s"],
            "save_s": save_s, "to_host_s": to_host_s}
        nbytes = mgr.stats()["bytes_written"]
        after = [spine_step(step, it)[1] for _ in range(2)]
    finally:
        f.close()
    del model, opt, step, it
    torch.cuda.empty_cache()

    model = tfm.Transformer(cfg, device="cuda")
    opt = tfm.adamw(model.parameters(), 1e-4)
    template = dict(train_state_to_jax(model, opt, device="meta"),
                    stream=np.zeros(1, np.int64))
    t0 = time.perf_counter()
    at, restored = mgr.restore_latest(template)
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_state_from_jax(restored, model, opt)
    torch.cuda.synchronize()
    to_card_s = time.perf_counter() - t0
    check(at == consumed and int(restored["stream"][0]) == consumed,
          f"restored step {at}, stream {restored['stream']}")
    restored_equal = bits_equal(restored, saved)
    del restored
    back = dict(train_state_to_jax(model, opt), stream=saved["stream"])
    state_equal = bits_equal(back, saved)
    del back
    check(restored_equal and state_equal,
          f"restored state differs: file {restored_equal}, "
          f"model {state_equal}")
    big = max((t for t in saved["params"]["blocks"].values()),
              key=lambda t: t.numel())
    raw = big.reshape(-1).view(torch.uint8).numpy()
    t0 = time.perf_counter()
    native.crc32c(raw)
    crc_s = time.perf_counter() - t0
    del saved, held
    step = tfm.make_train_step(model, opt, ledger=False)
    f = spine_feed(uri)
    try:
        it = iter(f)
        for _ in range(consumed):   # fast-forward to the stream position
            next(it)
        resumed = [spine_step(step, it)[1] for _ in range(2)]
    finally:
        f.close()
    del model, opt, step, it
    torch.cuda.empty_cache()
    diff = [abs(a - b) / abs(b) for a, b in zip(resumed, after)]
    check(max(diff) <= 1e-3, f"resumed losses {resumed} vs {after}")
    return {
        "phase": "spine_checkpoint", "n_layers": cfg.n_layers,
        "step": consumed, "bytes": nbytes,
        "leaves": len(mgr_leaves(ckpt_dir, consumed)),
        "to_host_s": to_host_s, "save_s": save_s,
        "save_GBps": nbytes / save_s / 1e9, "restore_s": restore_s,
        "restore_GBps": nbytes / restore_s / 1e9, "to_card_s": to_card_s,
        "crc32c_bytes": raw.size, "crc32c_GBps": raw.size / crc_s / 1e9,
        "crc32c_sse42": native.crc32c_hardware(),
        "state_bitwise_equal": restored_equal and state_equal,
        "losses_uninterrupted": after, "losses_resumed": resumed,
        "loss_abs_diff": [abs(a - b) for a, b in zip(resumed, after)],
        "loss_rel_diff": diff, "manager_stats": mgr.stats()}


def mgr_leaves(ckpt_dir, step):
    with open(os.path.join(ckpt_dir, f"step_{step:08d}",
                           "manifest.json")) as fh:
        return json.load(fh)["leaves"]


def spine_routes(uri):
    """One epoch through the packed transport and through the padded
    route of the same shard: every batch byte-equal on the card."""
    from dmlc_tpu_torch.feed import recordio_feed

    kw = dict(batch_records=SPINE_PER_PART, max_bytes=SPINE_REC,
              num_parts=SPINE_PARTS, device="cuda")
    padded = recordio_feed(uri, **kw)
    packed = recordio_feed(uri, pack_bytes=SPINE_PER_PART * SPINE_REC, **kw)
    n = 0
    try:
        for a, b in itertools.zip_longest(padded, packed):
            check(a is not None and b is not None,
                  f"the routes end at different batches ({n})")
            check(sorted(a) == sorted(b), f"keys {sorted(a)} {sorted(b)}")
            for k in a:
                check(torch.equal(a[k], b[k]), f"batch {n} {k} differs")
            n += 1
    finally:
        padded.close()
        packed.close()
    check(n == SPINE_RECORDS // (SPINE_PARTS * SPINE_PER_PART),
          f"{n} batches in the epoch")
    return {"phase": "spine_routes", "batches": n,
            "packed_equals_padded": True,
            "bytes_to_device": {"padded": padded.stats()["bytes_to_device"],
                                "packed": packed.stats()["bytes_to_device"]}}


def h2d_ceiling(nbytes, iters=32):
    """MB/s of non-blocking copies from one pinned host buffer of
    ``nbytes`` to the card, timed with CUDA events."""
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        dst.copy_(src, non_blocking=True)
    b.record()
    torch.cuda.synchronize()
    return nbytes * iters / 1e6 / (a.elapsed_time(b) / 1e3)


def feed_epoch(make, shard_bytes, name, device="cuda"):
    """One epoch of the feed ``make(device)`` over a shard of
    ``shard_bytes`` written by ``write_shard`` in SPINE_PARTS partitions:
    its payload MB/s into the device's memory, its first batch against
    the CPU feed's."""
    cpu = make("cpu")
    try:
        want = {k: v.clone() for k, v in next(iter(cpu)).items()}
    finally:
        cpu.close()
    f = make(device)
    payload = torch.zeros((), dtype=torch.int64, device=device)
    batches, exact = 0, None
    try:
        t0 = time.perf_counter()
        for b in f:
            if exact is None:
                exact = sorted(b) == sorted(want) and all(
                    torch.equal(b[k].cpu(), want[k]) for k in want)
            if "length" in b:
                payload += b["length"].sum()
            else:
                offs = b["offsets"].view(SPINE_PARTS, -1)
                payload += offs.gather(
                    1, b["count"].view(-1, 1).long()).sum()
            batches += 1
        if device == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        f.close()
    payload = int(payload)
    check(payload == (shard_bytes // (SPINE_REC + 8)) * SPINE_REC,
          f"{name}: {payload} payload bytes")
    check(exact, f"{name}: the first batch on the card differs from the "
          "CPU's")
    return {"MBps": payload / 1e6 / dt, "seconds": dt,
            "payload_bytes": payload, "batches": batches,
            "first_batch_equals_cpu": exact, "stats": f.stats()}


def spine_feed_rate(uri):
    """Payload MB/s into HBM over one epoch of the large shard on three
    routes, beside the pinned H2D rate at the same transfer size."""
    from dmlc_tpu_torch.feed import recordio_feed, recordio_packed_feed

    per_part_bytes = FEED_PER_PART * SPINE_REC
    routes = {
        "padded": lambda device: recordio_feed(
            uri, batch_records=FEED_PER_PART, max_bytes=SPINE_REC,
            num_parts=SPINE_PARTS, device=device),
        "packed_transport": lambda device: recordio_feed(
            uri, batch_records=FEED_PER_PART, max_bytes=SPINE_REC,
            num_parts=SPINE_PARTS, device=device, pack_bytes=per_part_bytes),
        "recordio_packed_feed": lambda device: recordio_packed_feed(
            uri, buf_bytes=per_part_bytes, max_records=FEED_PER_PART,
            num_parts=SPINE_PARTS, device=device),
    }
    doc = {"phase": "spine_feed_rate", "shard_bytes": os.path.getsize(uri),
           "num_parts": SPINE_PARTS, "batch_bytes": SPINE_PARTS
           * per_part_bytes}
    for name, make in routes.items():
        doc[name] = feed_epoch(make, doc["shard_bytes"], name)
    doc["h2d_pinned_MBps"] = h2d_ceiling(doc["batch_bytes"])
    return doc


def spine_phase(tfm, fa, cfg):
    """The data spine on the card: RecordIO shards written by the port,
    read through the input split and the device feed into the flagship
    train step, checkpointed and resumed in the JAX package's format.
    The ~6 GB train state is checkpointed at full depth where build/ has
    14 GB free, else a depth-4 copy at full width.  ``build/spine`` goes
    at the end."""
    root = os.path.join(ROOT, "build", "spine")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        free = shutil.disk_usage(root).free
        uri = os.path.join(root, "tokens.rec")
        toks = spine_tokens(SPINE_RECORDS, cfg.vocab, 0)
        write_shard(uri, toks)
        train_doc = spine_train(tfm, fa, cfg, uri, toks)
        torch.cuda.empty_cache()
        ckpt_cfg = (cfg if free >= 14e9
                    else dataclasses.replace(cfg, n_layers=4))
        ckpt_doc = spine_checkpoint(tfm, ckpt_cfg, uri,
                                    os.path.join(root, "ckpt"))
        ckpt_doc["disk_free_bytes"] = free
        shutil.rmtree(os.path.join(root, "ckpt"))
        routes_doc = spine_routes(uri)
        big = os.path.join(root, "feed.rec")
        t0 = time.perf_counter()
        write_shard(big, spine_tokens(FEED_SHARD_BYTES // (SPINE_REC + 8),
                                      cfg.vocab, 1))
        rate_doc = spine_feed_rate(big)
        rate_doc["write_s"] = time.perf_counter() - t0 - sum(
            rate_doc[r]["seconds"] for r in ("padded", "packed_transport",
                                             "recordio_packed_feed"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return train_doc, routes_doc, rate_doc, ckpt_doc


# ---------------------------------------------------------------------------
# phase 7l: the serving and feed paths under the lock-order and race checkers
# ---------------------------------------------------------------------------

LOCKCHECK_STEPS = 4   # train steps of the flagship fed by the DeviceFeed
LOCKCHECK_KNOBS = ("DMLC_LOCKCHECK", "DMLC_RACECHECK")


def _lockcheck_load(serving, model, cfg, tele):
    """The flagship engine (pool 256 x 16, max_active 8) behind its HTTP
    server, driven by the ``LoadGenerator`` (8 streams x 2 requests of
    17..511 prompt tokens, 32 new tokens): the load summary, the decode
    records of the step ledger and the engine's lock types."""
    tele.reset_steps()
    eng = serving.InferenceEngine(model, device="cuda", n_blocks=256,
                                  block_size=16, max_active=8,
                                  queue_depth=64)
    eng.start()
    srv = serving.ServingHTTPServer(eng)
    try:
        gen = serving.LoadGenerator(srv.url, n_streams=8,
                                    requests_per_stream=2,
                                    prompt_len=(17, 511), max_tokens=32,
                                    vocab=cfg.vocab, seed=0)
        load = gen.run()
        check(load["n_requests_ok"] == 16 and not gen.failures,
              f"lockcheck loadgen: {load} {gen.failures[:2]}")
        recs = tele.ledger().records()
    finally:
        srv.close()
        eng.close()
    locks = sorted({type(lk).__name__ for lk in (
        eng.scheduler._lock, eng.cache._lock, eng.cache._alloc._lock)})
    del eng, srv
    gc.collect()
    return load, recs, locks


def lockcheck_phase(smi, serving, tele, fa, pa, tfm, model, cfg):
    """The card's serving and feed paths with ``DMLC_LOCKCHECK=1`` and
    ``DMLC_RACECHECK=1`` set before anything of the phase is built (the
    checkers read them at each lock's construction), so every lock of the
    fresh engines, their schedulers, KV caches, HTTP servers, the
    DeviceFeed and its BufferPool is a ``CheckedLock``: two runs of the
    flagship engine under the load generator over HTTP (K1 prefills, K4
    decodes), then ``LOCKCHECK_STEPS`` train steps of a fresh flagship
    fed by a ``recordio_feed`` over a RecordIO shard under
    ``build/lockcheck`` (K1-K3, the feed's worker threads and pool).
    Gates: no lock-order violation, no racecheck mismatch against the race
    pass's static map, acquire sites observed, every kernel launched.  The
    same load runs with plain locks (the knobs unset) before and after the
    two checked runs, so the checkers' cost reads as the decode step p50s
    of the four runs in ABBA order.  The knobs are restored when the
    checked part ends."""
    from dmlc_tpu_torch import concurrency as conc
    from dmlc_tpu_torch.examples import train_lm_recordio as ex

    t_phase = time.perf_counter()
    kernels = {"flash_fwd": fa.FLASH_FWD, "flash_bwd_dkv": fa.FLASH_BWD_DKV,
               "flash_bwd_dq": fa.FLASH_BWD_DQ,
               "paged_attention": pa.PAGED_ATTENTION}
    saved = {k: os.environ.pop(k, None) for k in LOCKCHECK_KNOBS}
    root = os.path.join(ROOT, "build", "lockcheck")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    runs = {}   # load summary, decode records and lock types of each run
    try:
        runs["plain_a"] = _lockcheck_load(serving, model, cfg, tele)
        uri = os.path.join(root, "tokens.rec")
        write_shard(uri, spine_tokens(SPINE_PARTS * SPINE_PER_PART
                                      * (LOCKCHECK_STEPS + 2), cfg.vocab, 3))
        for k in LOCKCHECK_KNOBS:
            os.environ[k] = "1"
        conc.lockcheck_reset()
        t_checked = time.perf_counter()
        for kern in kernels.values():
            kern.launches = 0
        for name in ("checked_b", "checked_b2"):
            runs[name] = _lockcheck_load(serving, model, cfg, tele)
        serve_launches = {n: k.launches for n, k in kernels.items()}
        train_model = tfm.init_params(
            cfg, torch.Generator("cuda").manual_seed(0), "cuda")
        step = tfm.make_train_step(train_model,
                                   tfm.adamw(train_model.parameters(), 1e-4))
        feed = spine_feed(uri)
        check(isinstance(feed._stats_lock, conc.CheckedLock),
              "the feed's locks are not checked")
        losses = []
        try:
            it = iter(feed)
            for _ in range(LOCKCHECK_STEPS):
                losses.append(step(*ex.batch_tokens(next(it))).item())
            feed_stats = feed.stats()
        finally:
            feed.close()
        del step, train_model
        torch.cuda.empty_cache()
        launches = {n: k.launches for n, k in kernels.items()}
        checked_s = time.perf_counter() - t_checked
        t_report = time.perf_counter()
        violations = conc.lockcheck_report()
        mismatches = conc.racecheck_report()
        observed = conc.racecheck_observed()
        report_s = time.perf_counter() - t_report
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
    conc.lockcheck_reset()
    runs["plain_a2"] = _lockcheck_load(serving, model, cfg, tele)
    check(not violations, f"lockcheck: {violations[:4]}")
    check(not mismatches, f"racecheck: {mismatches[:4]}")
    check(observed, "racecheck observed no acquire site")
    check(all(math.isfinite(x) for x in losses), f"lockcheck losses {losses}")
    check(all(n > 0 for n in launches.values()),
          f"lockcheck: a kernel never launched: {launches}")
    check(serve_launches["flash_bwd_dkv"] == 0
          and all(launches[n] == LOCKCHECK_STEPS * cfg.n_layers
                  for n in ("flash_bwd_dkv", "flash_bwd_dq")),
          f"lockcheck launches: serving {serve_launches}, all {launches}")
    locks = {name: run[2] for name, run in runs.items()}
    check(all(v == (["CheckedLock"] if name.startswith("checked")
                    else ["lock"]) for name, v in locks.items()),
          f"lockcheck: the runs' lock types {locks}")
    walls = {name: [r["wall_s"] for r in run[1]] for name, run in runs.items()}
    return {
        "phase": "lockcheck", "card": smi, "seconds":
            time.perf_counter() - t_phase,
        "checked_s": checked_s, "report_s": report_s,
        "violations": len(violations), "mismatches": len(mismatches),
        "observed_sites": len(observed),
        "observed_files": sorted({base for base, _ in observed}),
        "observed_locks": sorted({n for v in observed.values() for n in v}),
        "requests": sum(run[0]["n_requests_ok"] for name, run in runs.items()
                        if name.startswith("checked")),
        "train_steps": LOCKCHECK_STEPS, "losses": losses,
        "launches": launches, "serve_launches": serve_launches,
        "feed_batches": feed_stats["batches"],
        "decode_step_p50_s": pctl(walls["checked_b"] + walls["checked_b2"],
                                  50),
        "plain_decode_step_p50_s": pctl(walls["plain_a"] + walls["plain_a2"],
                                        50),
        "runs": {name: {"decode_steps": len(walls[name]),
                        "decode_step_p50_s": pctl(walls[name], 50),
                        **{k: run[0][k] for k in (
                            "wall_s", "aggregate_tokens_per_s", "p50_ttft_s",
                            "p99_ttft_s")}}
                 for name, run in runs.items()}}, launches


# ---------------------------------------------------------------------------
# phase 7i: the interleaving explorer over the port's classes
# ---------------------------------------------------------------------------

INTERLEAVE_TEETH = 400       # schedules the reverted drain must fail within
INTERLEAVE_SCHEDULES = 64    # schedules of each scenario on the card
INTERLEAVE_BUDGET_S = 20.0
INTERLEAVE_PROMPTS = ([1, 2, 3], [4, 5, 6, 7, 8])


def _interleave_serve(serving, model, device):
    """The scenario's ``max_active`` (2) engine serving the two prompts
    (8 new tokens each, both queued before it starts), with a thread
    reading the compute ledger's report throughout.  Returns the tokens
    and the reader's errors."""
    from dmlc_tpu_torch import telemetry as tele

    eng = serving.InferenceEngine(model, device=device, n_blocks=16,
                                  block_size=16, max_active=2,
                                  queue_depth=4)
    reqs = [eng.submit(p, max_new_tokens=8) for p in INTERLEAVE_PROMPTS]
    stop, errors = threading.Event(), []

    def reader():
        try:
            while not stop.is_set():
                tele.compute.report()
        except BaseException as e:  # noqa: BLE001 - the gate
            errors.append(repr(e))

    th = threading.Thread(target=reader, daemon=True)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)   # switch while a lock is held
    th.start()
    try:
        eng.start()
        done = [r.wait(60) for r in reqs]
    finally:
        stop.set()
        th.join(30)
        sys.setswitchinterval(interval)
        eng.close()
    check(done == [True, True] and all(r.error is None for r in reqs),
          f"interleave serve on {device}: done {done}, errors "
          f"{[r.error for r in reqs]}")
    return [list(r.generated) for r in reqs], errors


def interleave_phase(smi, serving, fa, pa, device="cuda"):
    """The explorer's teeth (the reverted drain caught and replayed), the
    five scenarios on the current tree with the drain scenario's engine
    on ``device``, then an engine of the scenario's key serving there
    after them, its tokens held against a CPU engine's.  Returns the
    phase's line and the serve's K1/K4 launches."""
    import copy
    import logging

    from dmlc_tpu_torch.analysis import interleave as ilv
    from dmlc_tpu_torch.analysis import scenarios as sc
    from dmlc_tpu_torch.models.transformer import TransformerConfig
    from dmlc_tpu_torch.serving import engine as eng_mod

    t_phase = time.perf_counter()
    kernels = {"flash_fwd": fa.FLASH_FWD, "flash_bwd_dkv": fa.FLASH_BWD_DKV,
               "flash_bwd_dq": fa.FLASH_BWD_DQ,
               "paged_attention": pa.PAGED_ATTENTION}
    # the router's state-change warnings, thousands of them
    quiet = logging.getLogger("dmlc_tpu_torch.serving")
    level = quiet.level
    quiet.setLevel(logging.ERROR)
    try:
        for k in kernels.values():
            k.launches = 0
        res, rep = sc.catch_reverted_drain(INTERLEAVE_TEETH, 0,
                                           device=device)
        teeth_s = time.perf_counter() - t_phase
        check(not res.ok, f"the explorer missed the reverted drain in "
                          f"{res.runs} schedules")
        fail = res.failures[0]
        check("swept by a concluding drain" in fail.error,
              f"reverted drain: wrong failure {fail.error}")
        check(rep is not None and not rep.ok and rep.error == fail.error
              and rep.decisions == fail.decisions,
              f"the failure did not replay: {rep}")
        t0 = time.perf_counter()
        results = sc.run_all(INTERLEAVE_SCHEDULES, 0, verbose=False,
                             device=device)
        scenarios_s = time.perf_counter() - t0
        bad = {n: r.failures[0].error for n, r in results.items()
               if not r.ok}
        check(not bad and len(results) == 5, f"interleave scenarios {bad}")
        scenario_launches = {n: k.launches for n, k in kernels.items()}
        check(not any(scenario_launches.values()),
              f"a kernel launched under the scenarios: {scenario_launches}")
        captured = [key for key, site in eng_mod._PROGRAMS.items()
                    if isinstance(getattr(site, "_lock", None),
                                  ilv.SchedLock)]
        check(not captured, f"scenario locks in the programs: {captured}")
    finally:
        quiet.setLevel(level)
    t0 = time.perf_counter()
    cfg = TransformerConfig(vocab=32, d_model=128, n_heads=2, head_dim=64,
                            d_ff=256, n_layers=1, n_experts=1)
    cpu_model = sc.tiny_model("cpu", cfg=cfg)
    card_model = copy.deepcopy(cpu_model).to(device)
    want, cpu_errors = _interleave_serve(serving, cpu_model, "cpu")
    for k in kernels.values():
        k.launches = 0
    got, reader_errors = _interleave_serve(serving, card_model, device)
    serve_launches = {n: k.launches for n, k in kernels.items()}
    serve_s = time.perf_counter() - t0
    check(not reader_errors and not cpu_errors,
          f"interleave: /compute reader {reader_errors} {cpu_errors}")
    check(got == want, f"interleave serve: {device} {got} != cpu {want}")
    if device == "cuda":
        check(serve_launches["flash_fwd"] >= 2
              and serve_launches["paged_attention"] >= 1,
              f"interleave serve launches {serve_launches}")
    seconds = time.perf_counter() - t_phase
    check(seconds <= INTERLEAVE_BUDGET_S,
          f"interleave phase took {seconds:.2f} s > {INTERLEAVE_BUDGET_S} s")
    return {
        "phase": "interleave", "card": smi, "device": device,
        "seconds": seconds, "budget_s": INTERLEAVE_BUDGET_S,
        "teeth_s": teeth_s, "scenarios_s": scenarios_s, "serve_s": serve_s,
        "teeth": {"schedules": INTERLEAVE_TEETH, "seed": 0,
                  "caught_on_run": res.runs, "error": fail.error,
                  "decisions": fail.decisions, "replayed": True},
        "scenarios": {n: {"schedules": r.runs, "ok": r.ok}
                      for n, r in results.items()},
        "schedules_run": res.runs + sum(r.runs for r in results.values()),
        "launches": scenario_launches,
        "serve": {"tokens": got, "cpu_tokens_equal": got == want,
                  "launches": serve_launches}}, serve_launches


# ---------------------------------------------------------------------------
# phase 7a: remote filesystems — the LM example over s3:// and gs://
# ---------------------------------------------------------------------------

REMOTE_LAYERS = 2          # the flagship's widths at depth 2
REMOTE_STEPS, REMOTE_SAVE_AT = 6, 4   # (a) 6 steps; (b) to 4; (c) 5-6
REMOTE_PART_MB = 8         # DMLC_S3_WRITE_BUFFER_MB of the uploads
REMOTE_CORRUPT = 2         # corrupted responses in the integrity epoch
REMOTE_LOSS_RTOL = 1e-3    # resumed against uninterrupted, the spine's gate
#: the emulators' credentials and the uploads' part size
REMOTE_ENV = {"AWS_ACCESS_KEY_ID": "AKIASMOKE",
              "AWS_SECRET_ACCESS_KEY": "smoke-secret-key",
              "AWS_REGION": "us-smoke-1",
              "DMLC_S3_WRITE_BUFFER_MB": str(REMOTE_PART_MB)}
#: the example's shard, the feed-rate shard on each store, the checkpoints
REMOTE_URIS = {"lm": "s3://smoke/lm/tokens.rec", "s3": "s3://smoke/feed.rec",
               "gs": "gs://smoke/feed.rec", "ckpt": "gs://smoke/ckpt/lm"}
#: the card's run; ``tests/test_torch_checkpoint_remote.py`` passes a small
#: config, the CPU and a small feed shard under its temporary directory
REMOTE_RUN = dict(device="cuda", cfg=None, feed_bytes=FEED_SHARD_BYTES,
                  dir=None)


def start_stores(env):
    """``chip_stores.py`` in a child process; ``(process, {"s3": port,
    "gcs": port})``."""
    proc = subprocess.Popen([sys.executable,
                             os.path.join(ROOT, "chip_stores.py")],
                            stdout=subprocess.PIPE, text=True, env=env,
                            start_new_session=True)
    line = proc.stdout.readline()
    if not line:
        proc.kill()
        check(False, f"remote: the store emulators exited ({proc.wait()})")
    return proc, json.loads(line)


def _drop_remote_instances():
    from dmlc_tpu_torch.io.filesys import FileSystem

    for key in [k for k in FileSystem._instances
                if k.startswith(("s3://", "gs://"))]:
        del FileSystem._instances[key]


def copy_object(src, dst, chunk=8 << 20):
    """``src`` to ``dst`` through the port's streams."""
    from dmlc_tpu_torch.io.stream import Stream

    with Stream.create(src, "r") as a, Stream.create(dst, "w") as b:
        while True:
            data = a.read(chunk)
            if not data:
                return
            b.write(data)


def lm_records(path, n):
    """The first ``n`` records of a local RecordIO shard, as bytes."""
    from dmlc_tpu_torch.io.recordio import RecordIOReader
    from dmlc_tpu_torch.io.stream import Stream

    with Stream.create(path, "r") as s:
        return list(itertools.islice(iter(RecordIOReader(s)), n))


def remote_epoch(uri, device):
    """Every batch of one epoch of the LM example's feed over ``uri``, on
    the host."""
    from dmlc_tpu_torch.examples import train_lm_recordio as ex
    from dmlc_tpu_torch.feed import recordio_feed

    f = recordio_feed(uri, batch_records=ex.PER_PART,
                      max_bytes=(ex.SEQ + 1) * 4, device=device)
    try:
        return [{k: v.cpu() for k, v in b.items()} for b in f]
    finally:
        f.close()


def remote_phase(smi, run=None):
    """The port's LM example against object stores: its shard uploaded to
    ``s3://`` and read back through the input split and the feed, the
    flagship at depth 2 trained from it with its checkpoints on ``gs://``
    and resumed from there, an epoch through verified reads with injected
    corruption, and the feed's MB/s from both stores beside a local
    file's.  The stores are ``chip_stores.py``'s emulators in a child
    process.  Returns the phase's line and K1-K3 launches over the three
    training runs."""
    run = {**REMOTE_RUN, **(run or {})}
    root = run["dir"] or os.path.join(ROOT, "build", "remote")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t_phase = time.perf_counter()
    proc, ports = start_stores(dict(os.environ, **REMOTE_ENV))
    try:
        with mock.patch.dict(os.environ, {
                **REMOTE_ENV,
                "DMLC_S3_ENDPOINT": f"127.0.0.1:{ports['s3']}",
                "STORAGE_EMULATOR_HOST": f"127.0.0.1:{ports['gcs']}"}):
            for key in ("AWS_SESSION_TOKEN", "GCS_OAUTH_TOKEN",
                        "DMLC_FAULT_SPEC", "DMLC_INTEGRITY_VERIFY_READS"):
                os.environ.pop(key, None)
            _drop_remote_instances()
            line, launches = _remote(smi, run, root, ports)
    finally:
        proc.kill()
        proc.wait()
        _drop_remote_instances()
        shutil.rmtree(root, ignore_errors=True)
    line["wall_s"] = time.perf_counter() - t_phase
    return line, launches


def _remote_uploads(run, root, ports, vocab):
    """The two shards to ``s3://`` through the port's RecordIO writer, the
    feed shard copied on to ``gs://`` and a local file; the numbers."""
    from dmlc_tpu_torch.examples import train_lm_recordio as ex
    from dmlc_tpu_torch.io.filesys import FileSystem
    from dmlc_tpu_torch.io.stream import Stream
    from dmlc_tpu_torch.io.uri import URI

    local_lm = os.path.join(root, "tokens.rec")
    ex.make_data(local_lm)
    t0 = time.perf_counter()
    ex.make_data(REMOTE_URIS["lm"])
    lm_s = time.perf_counter() - t0
    n_rec = run["feed_bytes"] // (SPINE_REC + 8)
    toks = spine_tokens(n_rec, vocab, 1)
    t0 = time.perf_counter()
    write_shard(REMOTE_URIS["s3"], toks)
    up_s = time.perf_counter() - t0
    del toks
    nbytes = FileSystem.get_instance(URI(REMOTE_URIS["s3"])).get_path_info(
        URI(REMOTE_URIS["s3"])).size
    with open(local_lm, "rb") as fh:
        lm_bytes = fh.read()
    with Stream.create(REMOTE_URIS["lm"], "r") as s:
        lm_equal = s.read(len(lm_bytes) + 1) == lm_bytes
    _, stats = http(f"http://127.0.0.1:{ports['s3']}/_stats", timeout=60)
    part = REMOTE_PART_MB << 20
    parts = -(-nbytes // part)
    check(lm_equal, "remote: the s3:// shard differs from make_data's file")
    check(nbytes == n_rec * (SPINE_REC + 8) and stats.get(
        "s3_parts_committed") == ([parts] if nbytes > part else None),
        f"remote: feed shard {nbytes} B in parts "
        f"{stats.get('s3_parts_committed')} (want {parts} of {part} B)")
    t0 = time.perf_counter()
    copy_object(REMOTE_URIS["s3"], REMOTE_URIS["gs"])
    to_gs_s = time.perf_counter() - t0
    local = os.path.join(root, "feed.rec")
    t0 = time.perf_counter()
    copy_object(REMOTE_URIS["s3"], local)
    to_local_s = time.perf_counter() - t0
    return local_lm, local, nbytes, {
        "lm_shard_bytes": len(lm_bytes), "lm_shard_s": lm_s,
        "feed_shard_bytes": nbytes, "feed_parts": parts, "part_bytes": part,
        "feed_upload_s": up_s, "feed_upload_MBps": nbytes / 1e6 / up_s,
        "s3_to_gs_MBps": nbytes / 1e6 / to_gs_s,
        "s3_to_local_MBps": nbytes / 1e6 / to_local_s,
        "signature_rejects": stats.get("s3_rejected", 0)}


def _remote_integrity(local_lm, device):
    """The first s3:// batch against the records as written, and an epoch
    through verified reads with REMOTE_CORRUPT responses corrupted: every
    batch equal to a clean epoch's, each corruption counted."""
    from dmlc_tpu_torch import telemetry as tele
    from dmlc_tpu_torch.examples import train_lm_recordio as ex
    from dmlc_tpu_torch.resilience import install_injector, reset_injector

    records = lm_records(local_lm, ex.PER_PART)
    clean = remote_epoch(REMOTE_URIS["lm"], device)
    want = torch.from_numpy(np.frombuffer(b"".join(records), np.uint8).copy())
    first_exact = bool(torch.equal(clean[0]["data"].reshape(-1), want) and
                       (clean[0]["length"] == (ex.SEQ + 1) * 4).all())
    check(first_exact, "remote: the first s3:// batch differs from the "
          "records as written")

    def counts():
        c = tele.counters_snapshot()
        return (c.get("integrity", {}).get("read_verify_failures", 0),
                c.get("resilience", {}).get("faults_injected", 0))

    before = counts()
    os.environ["DMLC_INTEGRITY_VERIFY_READS"] = "1"
    # the rule takes the first fetch of each pair: an unselected rule's
    # two firings land on both fetches of the first pair, alike, and the
    # compare passes them (ROADMAP Queue 3)
    install_injector(f"storage.response@fetch:read=corrupt::{REMOTE_CORRUPT}")
    try:
        verified = remote_epoch(REMOTE_URIS["lm"], device)
    finally:
        reset_injector()
        del os.environ["DMLC_INTEGRITY_VERIFY_READS"]
    fails, faults = (int(a - b) for a, b in zip(counts(), before))
    healed = len(verified) == len(clean) and all(
        sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
        for a, b in zip(verified, clean))
    check(healed and faults == REMOTE_CORRUPT and fails == REMOTE_CORRUPT,
          f"remote: verified epoch equal {healed}, corrupted responses "
          f"{faults}, read_verify_failures {fails}")
    return {"batches": len(clean), "corrupted_responses": faults,
            "read_verify_failures": fails, "healed": healed,
            "first_batch_byte_exact": first_exact}


def _remote_train(cfg, device, kernels):
    """(a) REMOTE_STEPS uninterrupted steps of ``train_lm_recordio.run``
    over the s3:// shard, (b) a fresh run to REMOTE_SAVE_AT saving to
    gs://, a torn step put above it, (c) a fresh model resumed from gs://
    for the rest.  The runs, the saved and restored trees' facts, and the
    torn step's listing."""
    from dmlc_tpu_torch import telemetry as tele
    from dmlc_tpu_torch.checkpoint import CheckpointManager
    from dmlc_tpu_torch.examples import train_lm_recordio as ex
    from dmlc_tpu_torch.models import transformer as tfm

    card = device == "cuda"
    per_step, saved, restored, reads = [], {}, {}, {}
    make_step = tfm.make_train_step
    save, restore_latest = CheckpointManager.save, \
        CheckpointManager.restore_latest
    restore = ex.restore

    def counted_make(*a, **kw):
        step = make_step(*a, **kw)

        def counted(*sa, **skw):
            before = [k.launches for k in kernels.values()]
            out = step(*sa, **skw)
            per_step[-1].append([k.launches - n for k, n in
                                 zip(kernels.values(), before)])
            return out
        return counted

    def timed_save(self, step, tree):
        t0 = time.perf_counter()
        save(self, step, tree)
        saved[step] = {"tree": tree, "s": time.perf_counter() - t0,
                       "bytes": self.stats()["bytes_written"]}

    def timed_restore_latest(self, template):
        t0 = time.perf_counter()
        out = restore_latest(self, template)
        reads.update(s=time.perf_counter() - t0,
                     bytes=self.stats()["bytes_read"])
        return out

    def kept_restore(manager, model, optimizer, with_stream=True):
        step, pos = restore(manager, model, optimizer, with_stream)
        if step is not None:
            restored.update(step=step, pos=pos,
                            tree=ex.train_state(model, optimizer, pos))
        return step, pos

    tfm.make_train_step = counted_make
    CheckpointManager.save = timed_save
    CheckpointManager.restore_latest = timed_restore_latest
    ex.restore = kept_restore
    runs, torn = {}, {}
    try:
        for name, steps, where, seed in (
                ("uninterrupted", REMOTE_STEPS, None, 0),
                ("to_save", REMOTE_SAVE_AT, REMOTE_URIS["ckpt"], 0),
                ("resumed", REMOTE_STEPS - REMOTE_SAVE_AT,
                 REMOTE_URIS["ckpt"], 1)):
            if name == "resumed":
                # a torn step above the saved one: a shard, no manifest
                base = REMOTE_URIS["ckpt"]
                copy_object(f"{base}/step_{REMOTE_SAVE_AT:08d}/stream.0-1",
                            f"{base}/step_{REMOTE_SAVE_AT + 1:08d}/stream.0-1")
                mgr = CheckpointManager(base)
                torn = {"step_dirs": sorted(mgr._step_dirs()),
                        "latest_step": mgr.latest_step()}
            model = tfm.init_params(cfg, torch.Generator(device).manual_seed(
                seed), device)
            tele.reset_steps()
            for kern in kernels.values():
                kern.launches = 0
            per_step.append([])
            t0 = time.perf_counter()
            losses = ex.run(REMOTE_URIS["lm"], steps, where, device=device,
                            model=model)
            wall = time.perf_counter() - t0
            walls = [r["wall_s"] for r in tele.ledger().records()]
            runs[name] = {"losses": losses, "wall_s": wall,
                          "launches_per_step": per_step[-1],
                          "step_ms_p50": pctl(walls, 50) * 1e3,
                          "step_ms": [w * 1e3 for w in walls]}
            del model
            if card:
                torch.cuda.empty_cache()
        latest = CheckpointManager(REMOTE_URIS["ckpt"]).latest_step()
    finally:
        tfm.make_train_step = make_step
        CheckpointManager.save, CheckpointManager.restore_latest = \
            save, restore_latest
        ex.restore = restore
    return runs, saved, restored, reads, torn, latest


def _remote(smi, run, root, ports):
    from dmlc_tpu_torch.examples import train_lm_recordio as ex
    from dmlc_tpu_torch.feed import recordio_packed_feed
    from dmlc_tpu_torch.models import transformer as tfm
    from dmlc_tpu_torch.ops import flash_attention as fa

    device = run["device"]
    cfg = run["cfg"] or dataclasses.replace(tfm.flagship_config(),
                                            n_layers=REMOTE_LAYERS)
    line = {"phase": "remote", "card": smi, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "dtype": cfg.dtype,
            "B": ex.PER_PART, "T": ex.SEQ, "stores": "chip_stores.py"}
    walls = line["walls_s"] = {}
    t0 = time.perf_counter()
    local_lm, local_feed, nbytes, line["uploads"] = _remote_uploads(
        run, root, ports, cfg.vocab)
    walls["uploads"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    line["integrity"] = _remote_integrity(local_lm, device)
    walls["integrity"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    kernels = {"flash_fwd": fa.FLASH_FWD, "flash_bwd_dkv": fa.FLASH_BWD_DKV,
               "flash_bwd_dq": fa.FLASH_BWD_DQ}
    runs, saved, restored, reads, torn, latest = _remote_train(cfg, device,
                                                               kernels)
    walls["train"] = time.perf_counter() - t0
    a, b, c = (runs[n]["losses"] for n in ("uninterrupted", "to_save",
                                           "resumed"))
    rel = [abs(x - y) / abs(y) for x, y in zip(c, a[REMOTE_SAVE_AT:])]
    at_save = saved[REMOTE_SAVE_AT]
    state_equal = restored.get("step") == REMOTE_SAVE_AT and bits_equal(
        restored["tree"], at_save["tree"])
    per = [s for r in runs.values() for s in r["launches_per_step"]]
    want = [cfg.n_layers] * 3 if device == "cuda" else [0, 0, 0]
    check(torn["latest_step"] == REMOTE_SAVE_AT
          and REMOTE_SAVE_AT + 1 in torn["step_dirs"],
          f"remote: the torn step was not skipped: {torn}")
    check(all(math.isfinite(x) for x in a + b + c) and len(a) == REMOTE_STEPS
          and len(c) == REMOTE_STEPS - REMOTE_SAVE_AT,
          f"remote: losses {a} {b} {c}")
    check(restored.get("step") == REMOTE_SAVE_AT
          and restored.get("pos") == REMOTE_SAVE_AT,
          f"remote: resumed at step {restored.get('step')}, stream "
          f"position {restored.get('pos')}")
    check(state_equal, "remote: the state restored from gs:// differs from "
          "the state saved")
    check(max(rel) <= REMOTE_LOSS_RTOL,
          f"remote: resumed losses {c} against {a[REMOTE_SAVE_AT:]}")
    check(len(per) == 2 * REMOTE_STEPS and all(p == want for p in per),
          f"remote: K1-K3 launches per step {per}, want {want} each")
    check(latest == REMOTE_STEPS, f"remote: latest step {latest} after (c)")
    del restored["tree"]
    gb = at_save["bytes"] / 1e9
    line["train"] = {
        "runs": runs, "loss_rel_diff": rel,
        "to_save_vs_uninterrupted_max_abs": max(
            abs(x - y) for x, y in zip(b, a)),
        "state_bitwise_equal": state_equal,
        "restored_step": restored["step"],
        "restored_stream_position": restored["pos"],
        "saved_bytes": at_save["bytes"], "save_s": at_save["s"],
        "save_GBps": gb / at_save["s"], "restore_s": reads["s"],
        "restore_GBps": reads["bytes"] / 1e9 / reads["s"],
        "restored_bytes": reads["bytes"], "torn_step": torn,
        "latest_step_after": latest,
        "saves_s": {step: sv["s"] for step, sv in saved.items()}}
    del saved, at_save

    # the feed's MB/s from each store beside the local copy
    t0 = time.perf_counter()
    per_part = FEED_PER_PART * SPINE_REC
    line["feed_rate"] = {"route": "recordio_packed_feed",
                         "num_parts": SPINE_PARTS, "shard_bytes": nbytes}
    for name, uri in (("local", local_feed), ("s3", REMOTE_URIS["s3"]),
                      ("gs", REMOTE_URIS["gs"])):
        line["feed_rate"][name] = feed_epoch(
            lambda dev, uri=uri: recordio_packed_feed(
                uri, buf_bytes=per_part, max_records=FEED_PER_PART,
                num_parts=SPINE_PARTS, device=dev), nbytes,
            f"remote {name}", device)
    walls["feed_rate"] = time.perf_counter() - t0
    launches = {k: sum(p[i] for p in per) for i, k in enumerate(kernels)}
    line["launches"] = launches
    return line, launches


# ---------------------------------------------------------------------------
# phase 8: the sparse text path
# ---------------------------------------------------------------------------

SPARSE_PARTS, SPARSE_PER_PART = 4, 2048   # ~3.9 MB a global batch
CRITEO_INT, CRITEO_CAT = 13, 26           # Criteo's 39 features a row
SPARSE_NUM_COL = 1 << 20                  # hashed index space
SPARSE_LIBSVM_BYTES = 256 << 20
HIGGS_ROWS, HIGGS_COLS = 1_000_000, 28    # HIGGS-1M: a label, 28 floats
LOSS_STEPS = 50
# the RecordIO routes' MB/s on the 256 MB shard when the feed's scan and
# packs ran in numpy and Python (an earlier run of this script, H100
# 80GB HBM3, 700.00 W), printed beside this run's
NUMPY_ROUTE_RECORDIO_MBPS = {"padded": 439.65, "packed_transport": 158.62,
                             "recordio_packed_feed": 162.65}


def _ndigits(v):
    n = np.ones(v.shape, np.int64)
    for p in range(1, 19):
        n += v >= 10 ** p
    return n


def _put_uint(buf, pos, v, width=None):
    """Decimal digits of ``v`` (uint64) into ``buf`` at ``pos``, zero-padded
    to ``width`` when given; returns the digit counts."""
    nd = _ndigits(v) if width is None else np.full(v.shape, width, np.int64)
    for d in range(int(nd.max(initial=1))):
        m = nd > d
        buf[(pos + nd - 1 - d)[m]] = 48 + (v[m] // 10 ** d) % 10
    return nd


def _emit_rows(fields, seps):
    """One text block from ``fields``: a list of (kind, array [rows, k])
    items, kind ``"u"`` unsigned integers, ``"f6"`` signed fixed-point with
    6 decimals, ``"f3"`` fixed-point in [0, 1) with 3 decimals, each cell
    followed by the byte ``seps[i]`` (space, ':' or ',') and every row by
    a newline.  All vectorized: a cell's length, then offsets, then the
    digits in place."""
    rows = fields[0][1].shape[0]
    cells = []   # per column: (kind, values, length)
    for (kind, arr), sep in zip(fields, seps):
        for j in range(arr.shape[1]):
            v = arr[:, j]
            if kind == "u":
                ln = _ndigits(v) + 1
            elif kind == "f3":
                ln = np.full(rows, 6, np.int64)          # 0.xyz + sep
            else:
                q = np.rint(np.abs(v) * 1e6).astype(np.int64)
                ln = (v < 0) + _ndigits(q // 1_000_000) + 8   # . 6 digits sep
            cells.append((kind, v, ln, sep))
    lens = np.stack([c[2] for c in cells], 1)
    row_len = lens.sum(1)
    row_off = np.zeros(rows + 1, np.int64)
    np.cumsum(row_len, out=row_off[1:])
    buf = np.empty(int(row_off[-1]), np.uint8)
    pos = row_off[:-1].copy()
    for kind, v, ln, sep in cells:
        if kind == "u":
            _put_uint(buf, pos, v.astype(np.uint64))
        elif kind == "f3":
            buf[pos] = 48
            buf[pos + 1] = 46
            _put_uint(buf, pos + 2, np.rint(v * 1000).astype(np.uint64)
                      .clip(0, 999), width=3)
        else:
            q = np.rint(np.abs(v) * 1e6).astype(np.int64)
            neg = v < 0
            buf[pos[neg]] = 45
            p = pos + neg
            nd = _put_uint(buf, p, (q // 1_000_000).astype(np.uint64))
            buf[p + nd] = 46
            _put_uint(buf, p + nd + 1, (q % 1_000_000).astype(np.uint64),
                      width=6)
        pos = pos + ln
        buf[pos - 1] = ord(sep)
    buf[row_off[1:] - 1] = 10
    return buf


def criteo_rows(rng, n, w_true):
    """``n`` LibSVM rows in Criteo's shape: a 0/1 label drawn from the
    planted logistic model ``w_true``, 13 integer features (indices 0..12,
    values in [0, 1)) and 26 hashed categorical ones (indices in
    [13, 2^20), value 1)."""
    dense = np.round(rng.random((n, CRITEO_INT)), 3)
    cat = np.sort(rng.integers(CRITEO_INT, SPARSE_NUM_COL, (n, CRITEO_CAT)),
                  axis=1)
    logit = dense @ w_true[:CRITEO_INT] + w_true[cat].sum(1)
    label = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.int64)
    idx_dense = np.broadcast_to(np.arange(CRITEO_INT), (n, CRITEO_INT))
    fields = [("u", label[:, None])]
    seps = [" "]
    for j in range(CRITEO_INT):
        fields += [("u", idx_dense[:, j:j + 1]), ("f3", dense[:, j:j + 1])]
        seps += [":", " "]
    for j in range(CRITEO_CAT):
        fields += [("u", cat[:, j:j + 1]), ("u", np.ones((n, 1), np.int64))]
        seps += [":", " "]
    return _emit_rows(fields, seps)


def higgs_rows(rng, n, w_true):
    """``n`` CSV rows in HIGGS's shape: a 0/1 label (a planted linear
    rule on the features) and 28 float columns, 6 decimals."""
    x = rng.standard_normal((n, HIGGS_COLS))
    label = (x @ w_true + 0.5 * rng.standard_normal(n) > 0).astype(np.int64)
    return _emit_rows([("u", label[:, None]), ("f6", x)], [",", ","])


def write_sparse_files(root, libsvm_bytes=SPARSE_LIBSVM_BYTES,
                       higgs_rows_n=HIGGS_ROWS, seed=0):
    """The LibSVM and CSV files under ``root`` from ``seed``, in blocks
    of rows; returns their paths and row counts."""
    rng = np.random.default_rng(seed)
    w_svm = np.concatenate([rng.standard_normal(CRITEO_INT) * 2.0,
                            rng.standard_normal(SPARSE_NUM_COL - CRITEO_INT)
                            * 0.3])
    w_svm[:CRITEO_INT] -= w_svm[:CRITEO_INT].mean()
    svm = os.path.join(root, "criteo.libsvm")
    rows_svm = 0
    with open(svm, "wb") as f:
        size = 0
        while size < libsvm_bytes:
            n = min(100_000, max(1, (libsvm_bytes - size) // 380 + 1))
            buf = criteo_rows(rng, n, w_svm)
            f.write(buf.tobytes())
            size += buf.size
            rows_svm += n
    w_csv = rng.standard_normal(HIGGS_COLS)
    csv = os.path.join(root, "higgs.csv")
    with open(csv, "wb") as f:
        for lo in range(0, higgs_rows_n, 100_000):
            f.write(higgs_rows(rng, min(100_000, higgs_rows_n - lo),
                               w_csv).tobytes())
    return svm, rows_svm, csv, higgs_rows_n


def _batch_checksum(b):
    """(rows, checksum) of one sparse batch as int64 tensors on its
    device: the words of every label, value and index summed as integers,
    so equal batches give equal sums in any order."""
    rows = (b["mask"].sum(1) > 0).sum()
    chk = (b["label"].view(torch.int32).long().sum()
           + b["value"].view(torch.int32).long().sum()
           + b["index"].long().sum() + b["mask"].view(torch.int32).long()
           .sum())
    return rows, chk


def sparse_route(make, text_bytes):
    """One route of ``libsvm_feed``: its first batch on the CPU, then one
    epoch on the card, timed: the first batch byte-equal to the CPU's,
    the epoch's row count and checksum, MB/s of text parsed and of bytes
    placed, rows/s, the feed's parse and consumer-wait seconds."""
    cpu = make("cpu")
    try:
        want = {k: v.clone() for k, v in next(iter(cpu)).items()}
    finally:
        cpu.close()
    f = make("cuda")
    rows = torch.zeros((), dtype=torch.int64, device="cuda")
    chk = torch.zeros((), dtype=torch.int64, device="cuda")
    batches, first = 0, None
    try:
        t0 = time.perf_counter()
        for b in f:
            if first is None:
                first = {k: v.cpu() for k, v in b.items()}
            r, c = _batch_checksum(b)
            rows += r
            chk += c
            batches += 1
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        f.close()
    exact = sorted(first) == sorted(want) and all(
        torch.equal(first[k], want[k]) for k in want)
    st = f.stats()
    return {"first_batch_equals_cpu": exact, "rows": int(rows),
            "checksum": int(chk), "batches": batches, "seconds": dt,
            "text_MBps": text_bytes / 1e6 / dt,
            "placed_MBps": st["bytes_to_device"] / 1e6 / dt,
            "rows_per_s": int(rows) / dt, "parse_s": st["parse_s"],
            "consumer_wait_s": st["wait_s"], "stats": st}


def sparse_losses(make_svm, make_csv):
    """50 SGD steps on the card on fed batches with each example's loss:
    logistic on a [2^20] weight (``examples/train_libsvm.py:49-58``,
    lr 0.5) from the LibSVM feed and squared (``examples/train_csv.py:46-50``,
    lr 0.1) on a [28] weight from the CSV feed."""
    def logistic(w, b):
        x = b["value"] * b["mask"]
        p = torch.sigmoid((x * w[b["index"].long()]).sum(1))
        eps = 1e-7
        y = b["label"]
        return -(y * torch.log(p + eps)
                 + (1 - y) * torch.log(1 - p + eps)).mean()

    def squared(w, b):
        pred = (b["value"] * b["mask"] * w[b["index"].long()]).sum(1)
        return (pred - b["label"]).square().mean()

    out = {}
    for name, make, n_w, lr, loss_fn in (
            ("logistic", make_svm, SPARSE_NUM_COL, 0.5, logistic),
            ("squared", make_csv, HIGGS_COLS, 0.1, squared)):
        w = torch.zeros(n_w, device="cuda", requires_grad=True)
        f = make("cuda")
        losses = []
        try:
            for b in itertools.islice(f, LOSS_STEPS):
                loss = loss_fn(w, b)
                loss.backward()
                with torch.no_grad():
                    w -= lr * w.grad
                    w.grad = None
                losses.append(loss.detach())
        finally:
            f.close()
        losses = [x.item() for x in losses]
        check(len(losses) == LOSS_STEPS
              and all(math.isfinite(x) for x in losses),
              f"sparse {name} losses {losses}")
        first, last = losses[0], sum(losses[-5:]) / 5
        check(last < first, f"sparse {name} loss did not fall: {first} -> "
              f"{last} (mean of the last 5)")
        out[name] = {"losses": losses, "first": first, "last5_mean": last,
                     "lr": lr, "weight": n_w}
    return out


def sparse_phase(smi, rate_doc, spine_first_exact):
    """The sparse text path on the card: LibSVM (Criteo's row shape) and
    CSV (HIGGS's) files written from seed 0 under ``build/sparse``
    (removed after), fed through ``libsvm_feed`` on both routes, checked
    against the CPU and across routes, then 50 steps of each example's
    loss; the RecordIO routes' MB/s through the native scan beside the
    numpy route's.  The ``tracker`` phase runs on the same files before
    they are removed; its line comes back third.
    """
    from dmlc_tpu_torch.feed import libsvm_feed

    root = os.path.join(ROOT, "build", "sparse")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        t0 = time.perf_counter()
        svm, n_svm, csv, n_csv = write_sparse_files(root)
        write_s = time.perf_counter() - t0
        csv_uri = csv + "?format=csv&label_column=0"

        def make_svm(fmt):   # "libsvm": the fused route; "auto": classic
            return lambda device: libsvm_feed(
                svm, batch_size=SPARSE_PER_PART, max_nnz=CRITEO_INT
                + CRITEO_CAT, fmt=fmt, num_parts=SPARSE_PARTS,
                device=device)

        def make_csv(device):
            return libsvm_feed(csv_uri, batch_size=SPARSE_PER_PART,
                               max_nnz=HIGGS_COLS, fmt="csv",
                               num_parts=SPARSE_PARTS, device=device)

        svm_bytes, csv_bytes = os.path.getsize(svm), os.path.getsize(csv)
        routes = {"libsvm_fused": sparse_route(make_svm("libsvm"),
                                               svm_bytes),
                  "libsvm_classic": sparse_route(make_svm("auto"),
                                                 svm_bytes),
                  "csv_classic": sparse_route(make_csv, csv_bytes)}
        batch_bytes = SPARSE_PARTS * SPARSE_PER_PART * (
            4 + 12 * (CRITEO_INT + CRITEO_CAT))
        doc = {"phase": "sparse", "card": smi, "write_s": write_s,
               "libsvm": {"path": "criteo.libsvm", "bytes": svm_bytes,
                          "rows": n_svm, "features_per_row":
                          CRITEO_INT + CRITEO_CAT},
               "csv": {"path": "higgs.csv", "bytes": csv_bytes,
                       "rows": n_csv, "columns": HIGGS_COLS + 1},
               "num_parts": SPARSE_PARTS, "batch_rows": SPARSE_PER_PART,
               "libsvm_batch_bytes": batch_bytes, **routes,
               "h2d_pinned_MBps": h2d_ceiling(batch_bytes)}
        for name, r in routes.items():
            check(r["first_batch_equals_cpu"],
                  f"sparse {name}: the first batch on the card differs from "
                  "the CPU's")
        a, b = routes["libsvm_fused"], routes["libsvm_classic"]
        check(a["rows"] == b["rows"] == n_svm and a["checksum"]
              == b["checksum"], f"sparse: the LibSVM routes disagree: "
              f"{a['rows']}/{a['checksum']} vs {b['rows']}/{b['checksum']} "
              f"({n_svm} rows written)")
        check(routes["csv_classic"]["rows"] == n_csv,
              f"sparse csv: {routes['csv_classic']['rows']} of {n_csv} rows")
        doc["losses"] = sparse_losses(make_svm("libsvm"), make_csv)
        tracker_doc = tracker_phase(smi, svm, csv)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec = {"phase": "sparse_recordio", "card": smi,
           "first_batch_byte_exact": spine_first_exact,
           "shard_bytes": rate_doc["shard_bytes"]}
    for name, before in NUMPY_ROUTE_RECORDIO_MBPS.items():
        rec[name] = {"MBps": rate_doc[name]["MBps"],
                     "numpy_route_MBps": before,
                     "first_batch_equals_cpu":
                     rate_doc[name]["first_batch_equals_cpu"],
                     "parse_s": rate_doc[name]["stats"]["parse_s"],
                     "consumer_wait_s": rate_doc[name]["stats"]["wait_s"]}
    rec["h2d_pinned_MBps"] = rate_doc["h2d_pinned_MBps"]
    return doc, rec, tracker_doc


# ---------------------------------------------------------------------------
# phase 8b: the tracker, the launcher and the host collectives
# ---------------------------------------------------------------------------

TRACKER_WORKERS = 4
TRACKER_BENCH_BYTES = 16 << 20   # the sweep's largest size (64 MB: time)
GBDT_TOL = 1e-4   # relative: the tree allreduce's fold order vs a local sum
PARITY_ROWS = 32768   # the head of the Criteo-shaped file, card vs CPU
PARITY_RTOL = 1e-5    # per-rank epoch losses, card vs --device cpu
LIBSVM_ROWS = 49152   # train_libsvm's head of the file: a sixteenth of it
CSV_ROWS = 125_000    # train_csv's head of the HIGGS-shaped CSV: an eighth


def _dmlc_shm():
    return {n for n in os.listdir("/dev/shm") if n.startswith("dmlc")}


def _submit(name, argv, timeout, workers=TRACKER_WORKERS, log_dir=None):
    """One ``python -m dmlc_tpu_torch.tracker.submit --cluster local`` job
    in a session of its own (so a job cut at its timeout is killed whole);
    its output goes to ``tracker_<name>.log`` in ``log_dir`` (default
    ``chiprun_out``).  Fails unless it exits 0 and leaves no process of
    its session behind."""
    cmd = [sys.executable, "-m", "dmlc_tpu_torch.tracker.submit",
           "--cluster", "local", "--num-workers", str(workers),
           "--max-attempts", "1", "--host-ip", "127.0.0.1", "--", *argv]
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, err = proc.communicate()
    wall = time.perf_counter() - t0
    log_dir = log_dir or os.path.join(ROOT, "chiprun_out")
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, f"tracker_{name}.log"), "w") as f:
        f.write(f"$ {' '.join(cmd)}\nexit {proc.returncode}\n"
                f"--- stdout\n{out}\n--- stderr\n{err}")
    try:
        os.killpg(proc.pid, 0)
        left = True
    except ProcessLookupError:
        left = False
    if left:
        os.killpg(proc.pid, 9)
    check(proc.returncode == 0, f"tracker {name}: exit {proc.returncode}: "
          f"{err[-2000:]}")
    check(not left, f"tracker {name}: processes left behind")
    return out, err, wall


def _epochs(err, word):
    """{rank: {epoch: value}} from the examples' epoch lines."""
    out = {}
    for m in re.finditer(rf"rank (\d+): epoch (\d+) {word} ([0-9.]+)", err):
        out.setdefault(int(m.group(1)), {})[int(m.group(2))] = \
            float(m.group(3))
    return out


def _rendezvous_s(err):
    """Seconds from the tracker's ``listening`` line to its ``all N
    workers started`` line (the launcher's log clock): process start,
    imports and the brokering of every rank."""
    stamps = {}
    for key, pat in (("listen", r"INFO tracker listening on"),
                     ("started", r"INFO @tracker all \d+ workers started")):
        m = re.search(r"(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3}) " + pat,
                      err)
        check(m is not None, f"tracker log has no {key} line")
        h, mi, sec = m.group(1).split(" ")[1].replace(",", ".").split(":")
        stamps[key] = int(h) * 3600 + int(mi) * 60 + float(sec)
    return (stamps["started"] - stamps["listen"]) % 86400


def _finals(err):
    return {int(m.group(1)): json.loads(m.group(2)) for m in
            re.finditer(r"final rank (\d+): (\{.*\})", err)}


def _job_report(name, err, word, epochs, want_algo):
    """Gates and numbers of one distributed example run."""
    per = _epochs(err, word)
    fin = _finals(err)
    check(sorted(per) == list(range(TRACKER_WORKERS))
          and all(sorted(v) == list(range(epochs)) for v in per.values()),
          f"tracker {name}: epoch lines {per}")
    check(sorted(fin) == list(range(TRACKER_WORKERS)),
          f"tracker {name}: final lines for ranks {sorted(fin)}")
    mean = [sum(per[r][e] for r in per) / len(per) for e in range(epochs)]
    check(mean[-1] < mean[0], f"tracker {name}: mean epoch {word} did not "
          f"fall: {mean}")
    shas = {f["sha256"] for f in fin.values()}
    check(len(shas) == 1, f"tracker {name}: final weights differ across "
          f"ranks: {shas}")
    for r, f in fin.items():
        check(f["allreduce_algos"] == {want_algo: epochs * f["steps"]},
              f"tracker {name}: rank {r}'s gradient allreduces ran on "
              f"{f['allreduce_algos']}, not all on {want_algo}")
    steps = fin[0]["steps"]
    return {"epoch_" + word: mean, "per_rank": per, "steps": steps,
            "rendezvous_s": _rendezvous_s(err),
            "epoch_s": {r: f["epoch_s"] for r, f in fin.items()},
            "steps_per_s": {r: epochs * steps / sum(f["epoch_s"])
                            for r, f in fin.items()},
            "allreduce_algos": fin[0]["allreduce_algos"],
            "allreduce_ms_p50": {r: f["allreduce_ms_p50"]
                                 for r, f in fin.items()},
            "allreduce_ms_p99": {r: f["allreduce_ms_p99"]
                                 for r, f in fin.items()},
            "step_ms_p50": {r: f["step_ms_p50"] for r, f in fin.items()},
            "allreduce_share": {r: f["allreduce_share"]
                                for r, f in fin.items()},
            "sha256": shas.pop()}


def _head(svm, rows):
    """The first ``rows`` lines of ``svm`` in a file beside it."""
    head = svm + f".head{rows}"
    with open(svm, "rb") as f, open(head, "wb") as g:
        g.writelines(itertools.islice(f, rows))
    return head


def _libsvm_parity(svm):
    """The same 4-worker ``train_libsvm`` job on the head of the
    Criteo-shaped file, once on the card and once with ``--device cpu``:
    every rank's unrounded epoch losses agree within ``PARITY_RTOL``, so
    the card's gradient (the int64 gather and its backward) is the
    CPU's, not only one that lowers the loss."""
    head = _head(svm, PARITY_ROWS)
    argv = [sys.executable, "-m", "dmlc_tpu_torch.examples.train_libsvm",
            head, "2"]
    try:
        card = _finals(_submit("libsvm_head", argv, 300)[1])
        plain = _finals(_submit("libsvm_head_cpu", argv + ["--device", "cpu"],
                                300)[1])
    finally:
        os.unlink(head)
    ranks = list(range(TRACKER_WORKERS))
    check(sorted(card) == sorted(plain) == ranks
          and all(len(card[r]["losses"]) == len(plain[r]["losses"]) == 2
                  for r in ranks),
          f"tracker libsvm parity: final lines {card} vs {plain}")
    rel = max(abs(a - b) / abs(b) for r in ranks
              for a, b in zip(card[r]["losses"], plain[r]["losses"]))
    check(rel <= PARITY_RTOL, f"tracker libsvm parity: card losses "
          f"{[card[r]['losses'] for r in ranks]} vs CPU "
          f"{[plain[r]['losses'] for r in ranks]} (max rel {rel})")
    return {"rows": PARITY_ROWS, "epochs": 2, "rtol": PARITY_RTOL,
            "max_rel_diff": rel,
            "losses_card": {r: card[r]["losses"] for r in ranks},
            "losses_cpu": {r: plain[r]["losses"] for r in ranks},
            "allreduce_algos_card": card[0]["allreduce_algos"]}


def _gbdt(exe, workers):
    out, _, wall = _submit(f"gbdt_{workers}", [exe], 180, workers=workers)
    line = next((ln for ln in out.splitlines()
                 if ln.startswith("gbdt rmse=")), None)
    check(line is not None, f"gbdt with {workers} workers printed no rmse")
    return float(line.split("rmse=")[1].split()[0]), wall


def tracker_phase(smi, svm, csv):
    """4-worker jobs through the port's launcher: the distributed LibSVM
    and CSV examples on the card, the host-collective bench, and the C
    ABI's GBDT consumer (see the module docstring's ``tracker`` entry)."""
    from dmlc_tpu_torch.native import shm_collective as shmc

    shm_before = _dmlc_shm()
    shm_free = shutil.disk_usage("/dev/shm").free
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    # the hier group's chunk, by the C source's rule: the 4 MB default
    # capped at half the free /dev/shm over 2 slots a rank, floor 64 KB
    chunk = max(64 << 10, min(4 << 20, (shm_free // 2 // (TRACKER_WORKERS
                                                          * 2)) & ~7))
    doc = {"phase": "tracker", "card": smi, "compute_mode": mode,
           "host_cpus": os.cpu_count(), "workers": TRACKER_WORKERS,
           "dev_shm_free_bytes": shm_free, "shm_group_chunk_bytes": chunk}

    head = _head(svm, LIBSVM_ROWS)
    try:
        _, err, wall = _submit("libsvm", [
            sys.executable, "-m", "dmlc_tpu_torch.examples.train_libsvm",
            head, "2"], 600)
    finally:
        os.unlink(head)
    doc["libsvm"] = {"rows": LIBSVM_ROWS, "launcher_wall_s": wall,
                     **_job_report("libsvm", err, "loss", 2, "hier")}
    doc["libsvm_vs_cpu"] = _libsvm_parity(svm)
    head = _head(csv, CSV_ROWS)
    try:
        _, err, wall = _submit("csv", [sys.executable, "-m",
                                       "dmlc_tpu_torch.examples.train_csv",
                                       head, "2"], 300)
    finally:
        os.unlink(head)
    doc["csv"] = {"rows": CSV_ROWS, "launcher_wall_s": wall, **_job_report(
        "csv", err, "mse", 2, "tree")}

    out, _, wall = _submit("bench", [
        sys.executable, "-m", "dmlc_tpu_torch.examples.allreduce_worker",
        "bench",
        str(TRACKER_BENCH_BYTES), "3"], 300)
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    sweep = [d for d in lines if d["op"].startswith("host_allreduce_")
             and "algbw_MBps" in d]
    check(sorted({d["op"] for d in sweep}) == [
        "host_allreduce_hier", "host_allreduce_ring", "host_allreduce_tree"]
        and len(sweep) == 9, f"tracker bench: sweep lines {sweep}")
    tensors = next((d for d in lines
                    if d["op"] == "host_allreduce_overlap_tensors"), None)
    check(tensors is not None and tensors["equal_to_numpy"]
          and tensors["device"].startswith("cuda"),
          f"tracker bench: CUDA leaves through the bucketer: {tensors}")
    doc["bench"] = {"launcher_wall_s": wall, "sweep": sweep,
                    "overlap": next(d for d in lines
                                    if d["op"] == "host_allreduce_overlap"),
                    "cuda_leaves": tensors}

    lib = shmc.build()
    exe = os.path.join(ROOT, "build", "gbdt_allreduce")
    res = subprocess.run(
        ["gcc", "-O2", "-std=c99", "-I", str(shmc.CSRC),
         os.path.join(ROOT, "examples", "gbdt_allreduce.c"), str(lib),
         "-o", exe, "-lm", "-lrt", f"-Wl,-rpath,{lib.parent}"],
        capture_output=True, text=True, timeout=120)
    check(res.returncode == 0, f"gcc gbdt_allreduce.c: {res.stderr}")
    try:
        single, _ = _gbdt(exe, 1)
        multi, wall = _gbdt(exe, TRACKER_WORKERS)
    finally:
        os.unlink(exe)
    check(single < 0.3 and abs(multi - single) <= GBDT_TOL * single,
          f"gbdt: {TRACKER_WORKERS}-worker rmse {multi} vs single {single}")
    doc["gbdt"] = {"rmse_single": single, "rmse_4": multi,
                   "launcher_wall_s": wall, "tol_rel": GBDT_TOL}

    left = sorted(_dmlc_shm() - shm_before)
    check(not left, f"tracker: /dev/shm segments left behind: {left}")
    doc["dev_shm_left"] = left
    return doc


# ---------------------------------------------------------------------------
# phase 9: the flagship's model options — save_flash_mlp, routed top-k MoE
# (serving, training, the float32 check) and the self-healing trainer
# ---------------------------------------------------------------------------

MOE_EXPERTS, MOE_TOPK, MOE_CF = 8, 2, 1.25   # top-2 of 8 (GShard, Mixtral)
MOE_TRAIN_STEPS = 4
ROUTE_AGREE_MIN = 0.999   # f32 (token, choice) routes, kernels vs plain
MLP_AB_PAIRS = 6
SELFHEAL_STEPS = 30
SELFHEAL_RTOL = 1e-6      # where a trajectory is not bit-equal


def moe_config(cfg):
    """The flagship's widths and depth with top-2-of-8 routed experts at a
    capacity factor of 1.25."""
    return dataclasses.replace(cfg, n_experts=MOE_EXPERTS, moe_topk=MOE_TOPK,
                               moe_capacity_factor=MOE_CF)


def moe_capacity(cfg, n):
    """Slots an expert has for ``n`` routed tokens (``topk_ffn``'s rule)."""
    return max(int(-(-(cfg.moe_topk * n * cfg.moe_capacity_factor)
                     // cfg.n_experts)), 1)


def executed_flops_per_token(cfg, b, t):
    """Matmul FLOPs a token of a routed train step executes: the ledger's
    formula (``train_flops_per_token``, which counts every expert) with
    the expert term at the X·C slots the experts run for B·T tokens, and
    the gate's product."""
    e, hd, f, x = (cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.d_ff,
                   cfg.n_experts)
    n = b * t
    per_layer = (2 * 4 * e * hd + 2 * t * hd
                 + 2 * 3 * e * f * x * moe_capacity(cfg, n) / n + 2 * e * x)
    return 3.0 * (cfg.n_layers * per_layer + 2 * e * cfg.vocab)


def mlp_products(fn, cfg, n_tok):
    """Device ms and calls of the products of the in/gate products' shape
    (``aten::mm`` of ``[n_tok, E] @ [E, F]``) in one call of ``fn``: the
    forward's, any recomputation's, and the w_out backward's ``dh``,
    which has the same shape (L of them).  An ``aten::mm`` under another
    is the selective checkpoint's dispatch mode re-dispatching the same
    call, and is not counted again."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    want = [[n_tok, cfg.d_model], [cfg.d_model, cfg.d_ff]]
    ms, calls = 0.0, 0
    def nested(e):
        p = e.cpu_parent
        while p is not None:
            if p.name == "aten::mm":
                return True
            p = p.cpu_parent
        return False

    for e in prof.events():
        if (e.name == "aten::mm" and not nested(e)
                and [list(s) for s in e.input_shapes[:2]] == want):
            ms += e.device_time_total / 1e3
            calls += 1
    return ms, calls


def save_flash_mlp_phase(tfm, cfg):
    """The dense flagship train step at B=8 x T=1024 under ``save_flash``
    (A) and ``save_flash_mlp`` (B): two models from one seed, stepped in
    ABBA order on one batch, so their losses must stay equal step by
    step.  Each step's wall (synchronised), its peak memory above what
    was allocated before it, and, from one profiled step each, the device
    ms and calls of the in/gate products."""
    ids, labels = train_batch(cfg, TRAIN_B, TRAIN_T, 5)
    steps = {}
    for pol in ("save_flash", "save_flash_mlp"):
        m = tfm.init_params(dataclasses.replace(cfg, remat_policy=pol),
                            torch.Generator("cuda").manual_seed(0), "cuda")
        steps[pol] = tfm.make_train_step(m, tfm.adamw(m.parameters(), 1e-4),
                                         ledger=False)
    walls = {pol: [] for pol in steps}
    peaks = {pol: [] for pol in steps}
    losses = {pol: [] for pol in steps}
    order = ["save_flash", "save_flash_mlp"]
    for i in range(2 * MLP_AB_PAIRS):
        pol = order[0] if i % 4 in (0, 3) else order[1]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = steps[pol](ids, labels)
        torch.cuda.synchronize()
        walls[pol].append(time.perf_counter() - t0)
        peaks[pol].append(torch.cuda.max_memory_allocated() - base)
        losses[pol].append(loss.item())
    mm = {pol: mlp_products(lambda: steps[pol](ids, labels), cfg,
                            TRAIN_B * TRAIN_T) for pol in order}
    a, b = losses[order[0]], losses[order[1]]
    check(all(math.isfinite(x) for x in a + b), f"losses {losses}")
    rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    check(rel <= 1e-6, f"save_flash_mlp losses {b} vs save_flash {a}")
    doc = {"phase": "save_flash_mlp", "model": "flagship", "B": TRAIN_B,
           "T": TRAIN_T, "pairs": MLP_AB_PAIRS, "losses": losses,
           "losses_bit_equal": a == b, "loss_max_rel_diff": rel}
    # each model's first step also allocates its AdamW moments
    for pol in order:
        doc[pol] = {"step_ms_p50": median(walls[pol][1:]) * 1e3,
                    "step_ms": [w * 1e3 for w in walls[pol]],
                    "step_peak_bytes_above_state_p50":
                        median(peaks[pol][1:]),
                    "step_peak_bytes_above_state": peaks[pol],
                    "in_gate_mm_device_ms": mm[pol][0],
                    "in_gate_mm_calls": mm[pol][1]}
    del steps
    return doc


def moe_serve_phase(serving, fa, pa, tele, model, prompts, looping):
    """The routed flagship through the engine behind its HTTP server (K1
    prefill, K4 decode): after a one-request warm-up, the 8 requests with
    spec_k 0 and the 8 looping ones with spec_k 3, the launch counts
    zeroed just before and read just after; then a third pass with
    ``moe_debug_overflow`` on for the dropped-choice fraction (that pass
    syncs once a routed call)."""
    serve_batch(serving, model, [prompts[0][:17]], 0)   # warm-up
    torch.cuda.reset_peak_memory_stats()
    fa.FLASH_FWD.launches = 0
    pa.PAGED_ATTENTION.launches = 0
    plain = serve_batch(serving, model, prompts, 0)
    spec = serve_batch(serving, model, looping, 3)
    launches = {"flash_fwd": fa.FLASH_FWD.launches,
                "paged_attention": pa.PAGED_ATTENTION.launches}
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the routed serving path never launched: {launches}")
    cfg = model.cfg
    before = [tele.core.counter_value("moe", n) for n in
              ("overflow_checks", "overflow_fraction_sum")]
    model.cfg = dataclasses.replace(cfg, moe_debug_overflow=True)
    try:
        over = serve_batch(serving, model, prompts, 0)
    finally:
        model.cfg = cfg
    checks, frac_sum = [tele.core.counter_value("moe", n) - b0 for n, b0 in
                        zip(("overflow_checks", "overflow_fraction_sum"),
                            before)]
    check(checks > 0, "moe_debug_overflow recorded nothing")
    return {"phase": "moe_serve", "model": "flagship_moe_8x2",
            "plain": _emitted(plain), "spec": _emitted(spec),
            "launches": launches,
            "overflow_pass": {"tokens_per_s": over["tokens_per_s"],
                              "ttft_p50_s": over["ttft_p50_s"],
                              "overflow_checks": checks,
                              "overflow_fraction": frac_sum / checks},
            "peak_bytes": torch.cuda.max_memory_allocated()}, launches


def moe_train_phase(tfm, fa, tele, model):
    """4 AdamW steps of the routed flagship at B=8 x T=1024 through
    ``make_train_step(..., grad_norm=True)`` on one batch, launch counts
    zeroed just before: losses finite and falling, every norm finite,
    16 launches of each of K1, K2 and K3 a step; step walls, peak
    memory, the ledger's MFU and executed against ledger FLOPs."""
    cfg = model.cfg
    tele.reset_steps()
    opt = tfm.adamw(model.parameters(), 1e-4)
    step = tfm.make_train_step(model, opt, grad_norm=True)
    ids, labels = train_batch(cfg, TRAIN_B, TRAIN_T, 6)
    kernels = {"flash_fwd": fa.FLASH_FWD, "flash_bwd_dkv": fa.FLASH_BWD_DKV,
               "flash_bwd_dq": fa.FLASH_BWD_DQ}
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels.values():
        kern.launches = 0
    walls, losses, norms, per_step = [], [], [], []
    for _ in range(MOE_TRAIN_STEPS):
        before = [kern.launches for kern in kernels.values()]
        t0 = time.perf_counter()
        loss, gnorm = step(ids, labels)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(loss.item())
        norms.append(gnorm.item())
        per_step.append([kern.launches - n0
                         for kern, n0 in zip(kernels.values(), before)])
    launches = {name: kern.launches for name, kern in kernels.items()}
    check(all(math.isfinite(x) for x in losses + norms),
          f"routed losses {losses}, norms {norms}")
    check(losses[-1] < losses[0], f"routed loss did not fall: {losses}")
    check(all(n == [cfg.n_layers] * 3 for n in per_step),
          f"routed launches per step {per_step}")
    recs = tele.ledger().records()[-MOE_TRAIN_STEPS:]
    peak_bytes = torch.cuda.max_memory_allocated()
    # device time by category: a routed prefill, decode step, train step
    prof = profile_phase(tfm, model, cfg, {"train": lambda: step(ids,
                                                                 labels)})
    ledger_fpt = tfm.train_flops_per_token(cfg, TRAIN_T)
    exec_fpt = executed_flops_per_token(cfg, TRAIN_B, TRAIN_T)
    wall = median(walls[1:])
    tok_s = TRAIN_B * TRAIN_T / wall
    peak = PEAK_FLOPS[torch.bfloat16]
    del opt, step
    return {"phase": "moe_train", "model": "flagship_moe_8x2",
            "params": tfm.count_params(cfg), "B": TRAIN_B, "T": TRAIN_T,
            "capacity": moe_capacity(cfg, TRAIN_B * TRAIN_T),
            "lr": 1e-4, "losses": losses, "grad_norms": norms,
            "launches_per_step": dict(zip(kernels, per_step[0])),
            "step_ms_p50": wall * 1e3, "step_ms": [w * 1e3 for w in walls],
            "tokens_per_s": tok_s, "peak_bytes": peak_bytes,
            "ledger_flops_per_token": ledger_fpt,
            "executed_flops_per_token": exec_fpt,
            "ledger_mfu": pctl([r["mfu"] for r in recs], 50),
            "mfu_executed": exec_fpt * tok_s / peak,
            "mfu_ledger_formula": ledger_fpt * tok_s / peak,
            "profile": {k: v for k, v in prof.items() if k != "phase"}
            }, launches


def _record_routes(model, routes):
    """Wrap each layer's ``moe_ffn`` to append its tokens' sorted top-k
    expert indices to ``routes``; returns the undo."""
    for layer in model.layers:
        def record(x, c, route_tokens=None, layer=layer, **kw):
            if c.routed:
                probs = torch.softmax(
                    (x.reshape(-1, x.shape[-1]) @ layer.gate).float(), -1)
                routes.append(torch.topk(probs, c.moe_topk, dim=-1)
                              .indices.sort(dim=-1).values)
            return type(layer).moe_ffn(layer, x, c, route_tokens, **kw)
        layer.moe_ffn = record

    def undo():
        for layer in model.layers:
            del layer.moe_ffn
    return undo


def moe_check_phase(tfm, cfg):
    """The routed flagship at depth 2 in float32 on the card (B=2,
    T=1024), kernels against plain versions: the (token, choice) routes
    of every layer agree (each layer's gate top-k recorded on both
    paths), and on the tokens whose routes agree in every layer the
    logits and every gradient of the mean loss over them hold within
    the gradient check's tolerance.  In bf16 one rounding can flip a
    top-k choice, so the check runs in float32."""
    from dmlc_tpu_torch.ops.core import embed_lookup, rms_norm, softmax_xent

    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    model = tfm.init_params(cfg32, torch.Generator("cuda").manual_seed(7),
                            "cuda")
    ids, labels = train_batch(cfg32, 2, TRAIN_T, 8)
    positions = torch.arange(TRAIN_T, device="cuda")

    def forward(impl):
        routes = []
        undo = _record_routes(model, routes)
        try:
            x = embed_lookup(model.embed, ids)
            for layer in model.layers:
                x = layer(x, positions, cfg32, impl)
        finally:
            undo()
        return rms_norm(x, model.ln_f) @ model.unembed, routes

    out = {impl: forward(impl) for impl in (None, "torch")}
    same = torch.stack([a == b for a, b in zip(out[None][1],
                                               out["torch"][1])])
    agree = same.float().mean().item()
    mask = same.all(dim=-1).all(dim=0).reshape(ids.shape)   # [B, T]
    check(agree >= ROUTE_AGREE_MIN, f"f32 routes agree {agree}")

    def grads(logits):
        model.zero_grad(set_to_none=True)
        xent = softmax_xent(logits, labels)
        (xent * mask).sum().div(mask.sum()).backward()
        return [p.grad.float().clone() for p in model.parameters()]

    g = {impl: grads(out[impl][0]) for impl in out}
    rows = mask.reshape(-1)
    lk = out[None][0].detach().reshape(-1, cfg32.vocab)[rows]
    lp = out["torch"][0].detach().reshape(-1, cfg32.vocab)[rows]
    grad_err = max(rel_norm(a, b) if b.norm() > 0 else a.norm().item()
                   for a, b in zip(g[None], g["torch"]))
    doc = {"phase": "moe_check", "n_layers": 2, "dtype": "float32", "B": 2,
           "T": TRAIN_T, "route_agreement": agree,
           "tokens_agreeing": int(mask.sum()), "tokens": mask.numel(),
           "logits_rel_err": rel_norm(lk, lp), "grad_rel_err": grad_err,
           "tol": TRAIN_GRAD_TOL}
    check(doc["logits_rel_err"] <= TRAIN_GRAD_TOL,
          f"routed logits rel err {doc['logits_rel_err']}")
    check(grad_err <= TRAIN_GRAD_TOL, f"routed grads rel err {grad_err}")
    del model, out, g
    return doc


def _same_trajectory(got, want):
    """``(bit_equal, max relative difference)`` of two loss lists."""
    if len(got) != len(want):
        return False, math.inf
    rel = max((abs(a - b) / abs(b) for a, b in zip(got, want)), default=0.0)
    return got == want, rel


def selfheal_phase(fa):
    """The port's trainer (``examples/train_lm_recordio.run``, its example
    model in bf16) on the card from a shard ``make_data`` writes under
    ``build/selfheal`` (removed after), 30 steps with commits every 20,
    ``DMLC_SELFHEAL_MAX_SKIPS=2`` (the integrity smoke's phase B): an
    oracle run; a faulted run (3 poisoned steps at step 21: 2 skips, a
    rollback to step 20, the replay) equal to the oracle; a run with
    one transient skip at step 15, and a drift run with it and 3
    poisoned steps at step 25, whose rollback replays the 21 batches
    snapshotted at the step-20 commit and so equals the transient run.
    Trajectories are held bit-equal where they are, else within 1e-6
    relative; the ``dmlc_selfheal_*`` counters are read per run.  Then
    the faulted run once more under a port tracker at world 1
    (``DMLC_ELASTIC=1``, the trainer's elastic mode, in this process):
    its trajectory held to the oracle's the same way, and the tracker's
    ``/anomalies`` showing rank 0's remediation (2 skips, the
    rollback)."""
    from dmlc_tpu_torch import telemetry as tele
    from dmlc_tpu_torch.examples import train_lm_recordio as ex
    from dmlc_tpu_torch.resilience import (install_injector, reset_injector,
                                           reset_selfheal)
    from dmlc_tpu_torch.tracker import RabitTracker
    import contextlib
    import io

    root = os.path.join(ROOT, "build", "selfheal")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    data = os.path.join(root, "d.rec")
    ex.make_data(data)
    names = ("skips", "rollbacks", "nonfinite_steps")
    kernels = (fa.FLASH_FWD, fa.FLASH_BWD_DKV, fa.FLASH_BWD_DQ)
    os.environ["DMLC_SELFHEAL_MAX_SKIPS"] = "2"

    def run(tag, spec, env=None):
        reset_injector()
        reset_selfheal()
        if spec:
            install_injector(spec)
        c0 = [tele.core.counter_value("selfheal", n) for n in names]
        k0 = [k.launches for k in kernels]
        buf = io.StringIO()
        os.environ.update(env or {})
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                losses = ex.run(data, SELFHEAL_STEPS,
                                os.path.join(root, f"ck_{tag}"),
                                device="cuda")
        finally:
            reset_injector()
            for key in env or {}:
                os.environ.pop(key, None)
        return {"losses": losses, "out": buf.getvalue(),
                "wall_s": time.perf_counter() - t0,
                "counters": {n: tele.core.counter_value("selfheal", n) - c
                             for n, c in zip(names, c0)},
                "launches": [k.launches - n for k, n in zip(kernels, k0)]}

    def tracked(spec):
        """The run under a port tracker at world 1 (the JAX integrity
        smoke's setup); its ``/anomalies`` and ``/metrics`` read after
        the trainer's last beat."""
        tracker = RabitTracker("127.0.0.1", 1, metrics_port=0, elastic=True)
        tracker.start(1)
        base = f"http://127.0.0.1:{tracker.metrics_port}"
        try:
            r = run("tracked", spec, {
                "DMLC_ELASTIC": "1", "DMLC_TRACKER_URI": "127.0.0.1",
                "DMLC_TRACKER_PORT": str(tracker.port), "DMLC_TASK_ID": "0"})
            r["anomalies"] = json.loads(urllib.request.urlopen(
                base + "/anomalies", timeout=30).read())
            r["metrics"] = urllib.request.urlopen(
                base + "/metrics", timeout=30).read().decode()
            tracker.join(timeout=60)
        finally:
            tracker.close()
        return r

    try:
        runs = {"oracle": run("oracle", None),
                "faulted": run("faulted",
                               "selfheal.loss@step:21=corrupt::3"),
                "transient": run("transient",
                                 "selfheal.loss@step:15=corrupt::1"),
                "drift": run("drift", "selfheal.loss@step:15=corrupt::1;"
                                      "selfheal.loss@step:25=corrupt::3"),
                "tracked": tracked("selfheal.loss@step:21=corrupt::3")}
    finally:
        os.environ.pop("DMLC_SELFHEAL_MAX_SKIPS", None)
        shutil.rmtree(root, ignore_errors=True)
    o, f, t, d = (runs[k] for k in ("oracle", "faulted", "transient",
                                    "drift"))
    check(len(o["losses"]) == SELFHEAL_STEPS
          and all(math.isfinite(x) for x in o["losses"])
          and o["losses"][-1] < o["losses"][0],
          f"oracle losses {o['losses']}")
    check("rolled back to committed step 20; replaying 20 batches"
          in f["out"], f"faulted run: {f['out'][-2000:]}")
    check("rolled back to committed step 20; replaying 21 batches"
          in d["out"], f"drift run: {d['out'][-2000:]}")
    check(re.search(r"rolled back to committed step 20 \(rank 0\)",
                    runs["tracked"]["out"])
          and "replaying 20 batches" in runs["tracked"]["out"],
          f"tracked run: {runs['tracked']['out'][-2000:]}")
    want = {"faulted": {"skips": 2, "rollbacks": 1, "nonfinite_steps": 3},
            "tracked": {"skips": 2, "rollbacks": 1, "nonfinite_steps": 3},
            "transient": {"skips": 1, "rollbacks": 0, "nonfinite_steps": 1},
            "drift": {"skips": 3, "rollbacks": 1, "nonfinite_steps": 4}}
    for tag, counts in want.items():
        check(runs[tag]["counters"] == counts,
              f"{tag} counters {runs[tag]['counters']}, want {counts}")
    doc = {"phase": "selfheal", "steps": SELFHEAL_STEPS,
           "oracle_losses": o["losses"]}
    for tag, ref in (("faulted", o), ("drift", t), ("tracked", o)):
        bits, rel = _same_trajectory(runs[tag]["losses"], ref["losses"])
        check(bits or rel <= SELFHEAL_RTOL,
              f"{tag} trajectory off by {rel}: {runs[tag]['losses']}")
        doc[f"{tag}_bit_equal"] = bits
        doc[f"{tag}_max_rel_diff"] = rel
    # the tracker saw what the guard did (scripts/integrity_smoke.py's
    # gate on the JAX tracker)
    rank0 = runs["tracked"]["anomalies"].get("ranks", {}).get("0", {})
    remed = rank0.get("remediation") or {}
    check(remed.get("last_action") == "rollback"
          and remed.get("skips") == 2 and remed.get("rollbacks") == 1,
          f"tracked run: /anomalies remediation {remed}")
    check(rank0.get("steps", 0) > 0,
          f"tracked run: /anomalies rank 0 {rank0}")
    doc["tracked_remediation"] = remed
    doc["tracked_anomalies_rank0"] = {
        k: rank0.get(k) for k in ("steps", "step_time_s", "flags")}
    for tag, r in runs.items():
        check(all(n > 0 for n in r["launches"]),
              f"{tag}: K1-K3 launches {r['launches']}")
        doc[tag] = {"wall_s": r["wall_s"], "counters": r["counters"],
                    "launches": dict(zip(("flash_fwd", "flash_bwd_dkv",
                                          "flash_bwd_dq"), r["launches"]))}
    launches = {name: sum(r["launches"][i] for r in runs.values())
                for i, name in enumerate(("flash_fwd", "flash_bwd_dkv",
                                          "flash_bwd_dq"))}
    return doc, launches


def model_options_phase(tfm, serving, fa, pa, tele, cfg, prompts, looping):
    """Phase 9 in order, each model freed before the next: the
    save_flash_mlp A/B on the dense flagship, the routed flagship served
    and trained, its float32 check at depth 2, the self-heal runs.
    Returns the routed and self-heal paths' launches."""
    emit(save_flash_mlp_phase(tfm, cfg))
    gc.collect()
    torch.cuda.empty_cache()
    mcfg = moe_config(cfg)
    t0 = time.perf_counter()
    model = tfm.init_params(mcfg, torch.Generator("cuda").manual_seed(0),
                            "cuda")
    torch.cuda.synchronize()
    emit({"phase": "moe_model", "model": "flagship_moe_8x2",
          "params": tfm.count_params(mcfg),
          "bytes": sum(p.numel() * p.element_size()
                       for p in model.parameters()),
          "init_s": time.perf_counter() - t0, "n_experts": mcfg.n_experts,
          "moe_topk": mcfg.moe_topk,
          "moe_capacity_factor": mcfg.moe_capacity_factor})
    serve_doc, serve_launches = moe_serve_phase(serving, fa, pa, tele, model,
                                                prompts, looping)
    emit(serve_doc)
    gc.collect()
    torch.cuda.empty_cache()
    train_doc, train_launches = moe_train_phase(tfm, fa, tele, model)
    emit(train_doc)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    emit(moe_check_phase(tfm, mcfg))
    gc.collect()
    torch.cuda.empty_cache()
    heal_doc, heal_launches = selfheal_phase(fa)
    emit(heal_doc)
    return {"moe_serve": serve_launches, "moe_train": train_launches,
            "selfheal": heal_launches}


# ---------------------------------------------------------------------------
# phase 10: the elastic trainer — a worker lost and the world grown back
# ---------------------------------------------------------------------------

ELASTIC_WORKERS = 3
ELASTIC_STEPS = 11       # bounded by the smoke's time limit
ELASTIC_SAVE_EVERY = 5   # the job commits every 5 steps (the example's 20)
ELASTIC_KILL_AT = 6      # a worker is SIGKILLed once this step is seen
ELASTIC_GROW_AT = 8      # the world grows once world 2 has reached it
ELASTIC_LAYERS = 1       # the flagship's widths at depth 1 (see the phase)
ELASTIC_TIMEOUT_S = 420  # bound on the whole job
# a SIGKILLed same-host peer cannot poison the shm group its gang-mates
# wait in: they wake at DMLC_COLL_SHM_TIMEOUT_S.  It sits above any
# legitimate wait there (the others wait ~6 s in a state broadcast while
# rank 0 restores and flattens; rank 0's 1.5 GB save ~2 s) and below the
# tracker's miss window, so the survivors re-enter rendezvous before the
# death is declared and never beat under a stale rank (12 s and 14 s
# before the lockcheck phase paid for itself with 2 s of each)
ELASTIC_ENV = {"DMLC_ELASTIC": "1", "DMLC_TRACKER_MISS_WINDOW_S": "12",
               "DMLC_ELASTIC_GRACE_S": "1", "DMLC_COLL_SHM_TIMEOUT_S": "10",
               "DMLC_CLIENT_OP_TIMEOUT_S": "180", "OMP_NUM_THREADS": "2"}


def elastic_config():
    from dmlc_tpu_torch.models import transformer as tfm

    return dataclasses.replace(tfm.flagship_config(), n_layers=ELASTIC_LAYERS)


def elastic_worker(argv) -> int:
    """One worker of the elastic job: the flagship at depth 1 from seed
    0 through the port's ``train_lm_recordio.run`` (elastic under the
    launcher's ``DMLC_ELASTIC=1``).  Writes its pid, each state broadcast
    and its progress as they happen, and at the end its K1-K3 launches
    against its loss evaluations, the losses the guard saw by step, the
    step ledger's records, its goodput document and its parameters'
    SHA-256."""
    import hashlib

    sys.path.insert(0, ROOT)
    from dmlc_tpu_torch import resilience
    from dmlc_tpu_torch import telemetry as tele
    from dmlc_tpu_torch.examples import train_lm_recordio as ex
    from dmlc_tpu_torch.models import transformer as tfm
    from dmlc_tpu_torch.ops import flash_attention as fa
    from dmlc_tpu_torch.telemetry import compute, goodput

    shard, steps, ckpt, out = argv[0], int(argv[1]), argv[2], argv[3]
    # a joiner is started early, so that its start overlaps the world-2
    # steps, and enters the job once this file exists
    go = argv[4] if len(argv) > 4 else None
    task = os.environ["DMLC_TASK_ID"]

    def note(name, doc, mode="a"):
        with open(os.path.join(out, f"{name}.{task}"), mode) as f:
            f.write(json.dumps(doc) + "\n")

    note("pid", {"pid": os.getpid(), "port": os.environ["DMLC_TRACKER_PORT"]},
         "w")
    syncs = []
    broadcast = ex._ElasticTrainer._broadcast_state

    def hooked(self, done):
        done = broadcast(self, done)
        syncs.append(dict(self.last_sync, done=done, rank=self.client.rank,
                          world=self.client.world_size, t=time.time()))
        note("syncs", syncs[-1])
        return done

    ex._ElasticTrainer._broadcast_state = hooked
    observed = {}   # step -> (loss, verdict), the last observation wins

    class Guard(resilience.SelfHealGuard):
        def observe(self, loss, grad_norm=None, step=None):
            verdict = super().observe(loss, grad_norm=grad_norm, step=step)
            observed[step] = (float(loss), verdict)
            note("progress", {"step": step, "t": time.time()}, "w")
            return verdict

    resilience.SelfHealGuard = Guard
    calls = [0]
    loss_fn = tfm.unsharded_loss

    def counted(*a, **kw):
        calls[0] += 1
        return loss_fn(*a, **kw)

    tfm.unsharded_loss = counted
    ex.SAVE_EVERY = ELASTIC_SAVE_EVERY
    kernels = {"flash_fwd": fa.FLASH_FWD, "flash_bwd_dkv": fa.FLASH_BWD_DKV,
               "flash_bwd_dq": fa.FLASH_BWD_DQ}
    model = tfm.init_params(elastic_config(),
                            torch.Generator("cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    deadline = time.monotonic() + ELASTIC_TIMEOUT_S
    while go is not None and not os.path.exists(go):
        check(time.monotonic() < deadline, "elastic: the joiner never went")
        time.sleep(0.1)
    for kern in kernels.values():
        kern.launches = 0
    ex.run(shard, steps, ckpt, model=model)
    h = hashlib.sha256()
    for prm in model.parameters():
        h.update(prm.detach().float().cpu().numpy().tobytes())
    recs = [{k: r[k] for k in ("t_wall", "wall_s", "feed_wait_s",
                               "collective_s", "collective_overlapped_s",
                               "tokens")}
            for r in tele.ledger().records()]
    note("out", {"task": task, "syncs": syncs,
                 "observed": {str(k): v for k, v in observed.items()},
                 "loss_calls": calls[0],
                 "launches": {n: k.launches for n, k in kernels.items()},
                 "records": recs, "ledger": tele.ledger().summary(),
                 "goodput": goodput.status(), "sha256": h.hexdigest(),
                 "compute_sites": {
                     site: st["traces"]
                     for site, st in compute.report()["sites"].items()}},
         "w")
    return 0


def _jsonl(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


class TrackerPolls:
    """The elastic job's tracker read once a second: the last good
    reading of each endpoint, the wall time of each ``/trace`` read (the
    render plus the localhost transfer) and its size, and every anomaly
    flag seen active in any reading with its first ``since``.  A read
    the server answers with an error status fails the smoke; a refused
    connection is the tracker closing with the job's end, and so is a
    response cut short (the tracker's handler threads die with it), but
    only as the last read: a good reading after a torn one fails."""

    PATHS = ("/metrics", "/goodput", "/trace", "/anomalies", "/compute",
             "/incidents")

    def __init__(self, base):
        self.base = base
        self.last = {}
        self.flags = {}          # (rank, kind) -> since
        self.trace_reads = []    # (ms, bytes)
        self.torn = None         # the first response cut short
        self._t = 0.0

    def __call__(self):
        if time.monotonic() - self._t < 1.0:
            return
        self._t = time.monotonic()
        for path in self.PATHS:
            t0 = time.perf_counter()
            try:
                body = urllib.request.urlopen(self.base + path,
                                              timeout=10).read()
            except urllib.error.HTTPError as e:
                check(False, f"elastic: tracker {path} answered {e.code}")
            except OSError:
                return   # the tracker closes with the job's end
            except HTTPException as e:
                self.torn = self.torn or f"{path} ({e!r})"
                return
            check(self.torn is None,
                  f"elastic: tracker cut {self.torn} short and served on")
            ms = (time.perf_counter() - t0) * 1e3
            doc = body.decode() if path == "/metrics" else json.loads(body)
            self.last[path] = doc
            if path == "/trace":
                self.trace_reads.append((ms, len(body)))
            elif path == "/anomalies":
                for a in doc["active"]:
                    self.flags.setdefault((a["rank"], a["kind"]),
                                          a.get("since"))


def _poll(cond, what, deadline, job, tick=None):
    while not cond():
        check(job.poll() is None,
              f"elastic: the job ended ({job.returncode}) before {what} "
              f"(chiprun_out/elastic_job.log)")
        check(time.monotonic() < deadline, f"elastic: timed out: {what}")
        if tick is not None:
            tick()
        time.sleep(0.2)


def tracker_docs_check(polls, docs, alive, t_kill, t_grow_done):
    """The gates on the tracker's documents at the elastic job's last
    good reading (``alive``: the final rank of each live task); returns
    the numbers for the phase's line."""
    from dmlc_tpu_torch.telemetry import anomaly
    from dmlc_tpu_torch.telemetry.exporters import validate_exposition_text
    from dmlc_tpu_torch.telemetry.metric_names import METRIC_NAMES

    missing = [p for p in TrackerPolls.PATHS if p not in polls.last]
    check(not missing, f"elastic: no good reading of {missing}")
    trace, an = polls.last["/trace"], polls.last["/anomalies"]
    comp, inc = polls.last["/compute"], polls.last["/incidents"]
    # /trace: one process row per rank that shipped (pid = rank + 1) and
    # the tracker's at pid 0; every live rank with trainer step spans;
    # within a pid and thread, spans in the order they ended
    rows = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"]
            if e["ph"] == "M" and e["name"] == "process_name"}
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    check(rows.get(0) == "tracker", f"elastic: /trace rows {rows}")
    shipped = {e["pid"] for e in spans} - {0}
    check(all(rows.get(p, "").startswith(f"rank {p - 1}") for p in shipped),
          f"elastic: /trace rows {rows} for pids {sorted(shipped)}")
    held = {}
    for e in spans:
        held[e["pid"]] = held.get(e["pid"], 0) + 1
    for r in alive.values():
        check(any(e["pid"] == r + 1 and e["name"] == "step" for e in spans),
              f"elastic: /trace has no step span of rank {r}: {held}")
    ends, backwards = {}, 0
    for e in spans:
        end, key = e["ts"] + e["dur"], (e["pid"], e["tid"])
        if end < ends.get(key, end) - 0.01:   # 0.01 us: the ts rounding
            backwards += 1
        ends[key] = max(ends.get(key, end), end)
    check(backwards == 0, f"elastic: {backwards} spans out of order")
    # /anomalies: every live rank with steps and a step time; known kinds
    kinds = set(anomaly.ANOMALY_KINDS + anomaly.SLO_KINDS
                + anomaly.COMPUTE_KINDS + anomaly.FLEET_KINDS
                + anomaly.GOODPUT_KINDS)
    step_s = {}
    for t, r in alive.items():
        st = an["ranks"].get(str(r)) or {}
        wall = st.get("step_time_s")
        check(st.get("steps", 0) > 0 and isinstance(wall, float)
              and math.isfinite(wall) and wall > 0,
              f"elastic: /anomalies rank {r} {st}")
        own = [rec["wall_s"] for rec in docs[t]["records"]
               if rec["t_wall"] > t_grow_done]
        step_s[str(r)] = {"steps": st["steps"], "step_time_s": wall,
                          "ledger_p50_world3_again_s":
                              median(own) if own else None}
    seen = sorted(polls.flags.items())
    check(all(k in kinds for (_, k), _s in seen)
          and all(v["kind"] in kinds for v in an["recent_verdicts"]),
          f"elastic: unknown anomaly kinds {seen}")
    # /compute: every live rank's ledger shipped, its trainer's site
    # traced (the worker's own ledger names it), no storm
    for t, r in alive.items():
        check((comp["ranks"].get(str(r)) or {}).get("traces", 0) >= 1
              and docs[t]["compute_sites"].get("train.step", 0) >= 1,
              f"elastic: /compute rank {r} {comp['ranks'].get(str(r))}, "
              f"sites {docs[t]['compute_sites']}")
    check(comp["storming_ranks"] == []
          and not any(a["kind"] == "recompile_storm" for a in an["active"]),
          f"elastic: recompile storm {comp['storming_ranks']}")
    # /incidents: the shrink's episode.  The survivors bill ``resize``
    # from the moment their collective gives up on the dead peer
    # (DMLC_COLL_SHM_TIMEOUT_S after the kill), so its window, reached
    # back by that wait and the reporter's 2 s margin, holds the kill
    wait = float(ELASTIC_ENV["DMLC_COLL_SHM_TIMEOUT_S"]) + 2.0
    shrink = [i for i in inc["incidents"]
              if i["t0"] - wait <= t_kill <= i["t1"]]
    check(any((i["buckets"].get("resize", 0) > 0
               or i["buckets"].get("preempted", 0) > 0)
              and any(e["kind"] == "world_resized" for e in i["events"])
              for i in shrink),
          f"elastic: no incident of the kill at {t_kill}: "
          f"{[(i['t0'], i['t1'], i['buckets']) for i in inc['incidents']]}")
    # /metrics: exposition text, every family registered
    text = polls.last["/metrics"]
    validate_exposition_text(text)
    families = set(re.findall(r"^# TYPE (\S+) ", text, re.M))
    check(families <= METRIC_NAMES,
          f"elastic: unregistered families {families - METRIC_NAMES}")
    ms, nbytes = polls.trace_reads[-1]
    return {"spans_per_rank": {("tracker" if p == 0 else str(p - 1)): n
                               for p, n in sorted(held.items())},
            "trace_bytes": nbytes, "trace_read_ms": ms,
            "trace_read_ms_max": max(m for m, _ in polls.trace_reads),
            "trace_reads": len(polls.trace_reads),
            "anomalies_ranks": step_s,
            "flags_seen": [{"rank": r, "kind": k,
                            "since_minus_kill_s":
                                None if since is None else since - t_kill}
                           for (r, k), since in seen],
            "verdicts": [{"rank": v["rank"], "kind": v["kind"],
                          "t_minus_kill_s": v["t"] - t_kill}
                         for v in an["recent_verdicts"]],
            "compute_ranks": comp["ranks"],
            "incidents": [{"t0_minus_kill_s": i["t0"] - t_kill,
                           "t1_minus_kill_s": i["t1"] - t_kill,
                           "buckets": i["buckets"],
                           "events": sorted({e["kind"]
                                             for e in i["events"]}),
                           "anomalies": i["anomalies"]}
                          for i in inc["incidents"]],
            "families": len(families)}


def elastic_phase(smi):
    """The port's elastic trainer on the card (see the module docstring):
    3 workers under the port's launcher, one SIGKILLed after the first
    commit, the survivors' shrink, ``POST /resize`` and a fresh worker's
    grow back to 3, ``ELASTIC_STEPS`` steps.  Returns the phase's line
    and the K1-K3 launches summed over the workers."""
    from dmlc_tpu_torch.examples import train_lm_recordio as ex
    from dmlc_tpu_torch.models import transformer as tfm
    from dmlc_tpu_torch.tracker.rendezvous import free_port

    root = os.path.join(ROOT, "build", "elastic")
    shutil.rmtree(root, ignore_errors=True)
    out = os.path.join(root, "out")
    os.makedirs(out)
    shard, ckpt = os.path.join(root, "d.rec"), os.path.join(root, "ck")
    ex.make_data(shard)
    cfg = elastic_config()
    check((ex.PER_PART, ex.SEQ) == (TRAIN_B, ELASTIC_T),
          "elastic: flash_bwd_phase holds K1-K3 at another shape")
    logs = os.path.join(ROOT, "chiprun_out")
    os.makedirs(logs, exist_ok=True)
    shm0 = _dmlc_shm()
    mport = free_port()
    env = dict(os.environ, **ELASTIC_ENV,
               DMLC_TRACKER_METRICS_PORT=str(mport))
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    wargs = [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--elastic-worker", shard, str(ELASTIC_STEPS), ckpt, out]
    base = f"http://127.0.0.1:{mport}"
    t_start = time.time()
    deadline = time.monotonic() + ELASTIC_TIMEOUT_S
    job_log = open(os.path.join(logs, "elastic_job.log"), "w")
    joiner_log = open(os.path.join(logs, "elastic_joiner.log"), "w")
    job = subprocess.Popen(
        [sys.executable, "-m", "dmlc_tpu_torch.tracker.submit", "--cluster",
         "local", "--num-workers", str(ELASTIC_WORKERS), "--max-attempts",
         "1", "--host-ip", "127.0.0.1", "--", *wargs],
        cwd=ROOT, env=env, stdout=job_log, stderr=subprocess.STDOUT,
        start_new_session=True)
    joiner = None
    polls = TrackerPolls(base)
    try:
        def progress(task, after=0.0):
            doc = _jsonl(os.path.join(out, f"progress.{task}"))
            return doc[-1]["step"] if doc and doc[-1]["t"] > after else 0

        def synced(task, world):
            return [s["t"] for s in _jsonl(os.path.join(out, f"syncs.{task}"))
                    if s["world"] == world]

        _poll(lambda: progress(2) >= ELASTIC_KILL_AT
              and os.path.exists(os.path.join(
                  ckpt, f"step_{ELASTIC_SAVE_EVERY:08d}", "manifest.json")),
              "the first commit and the kill step", deadline, job, polls)
        victim = _jsonl(os.path.join(out, "pid.2"))[0]
        os.kill(victim["pid"], 9)
        t_kill = time.time()
        # the joiner reaches the card while the survivors shrink and
        # train at world 2; it enters the job after the /resize
        go = os.path.join(out, "go")
        joiner = subprocess.Popen(
            wargs + [go], cwd=ROOT, stdout=joiner_log,
            stderr=subprocess.STDOUT,
            env=dict(env, DMLC_TASK_ID="3", DMLC_TRACKER_URI="127.0.0.1",
                     DMLC_TRACKER_PORT=victim["port"], DMLC_ROLE="worker"),
            start_new_session=True)
        _poll(lambda: synced(0, 2) and synced(1, 2), "the shrink", deadline,
              job, polls)
        t_shrunk = time.time()
        _poll(lambda: progress(0, synced(0, 2)[0]) >= ELASTIC_GROW_AT,
              "steps at world 2", deadline, job, polls)
        req = urllib.request.Request(
            base + "/resize", data=json.dumps({"world": 3}).encode(),
            headers={"Content-Type": "application/json"})
        check(json.loads(urllib.request.urlopen(req, timeout=30).read())
              .get("requested"), "elastic: /resize refused")
        t_grow = time.time()
        open(go, "w").close()
        while job.poll() is None or joiner.poll() is None:
            check(time.monotonic() < deadline, "elastic: the job timed out")
            check(joiner.poll() in (None, 0),
                  f"elastic: the joiner exited {joiner.returncode} "
                  f"(chiprun_out/elastic_joiner.log)")
            polls()
            time.sleep(0.2)
    finally:
        for proc in (job, joiner):
            if proc is not None and proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
        job_log.close()
        joiner_log.close()
    wall = time.time() - t_start
    check(job.returncode == 0 and joiner.returncode == 0,
          f"elastic: job exit {job.returncode}, joiner {joiner.returncode}"
          f" (chiprun_out/elastic_job.log)")
    docs = {t: _jsonl(os.path.join(out, f"out.{t}"))[0] for t in (0, 1, 3)}
    pids = [_jsonl(os.path.join(out, f"pid.{t}"))[0]["pid"]
            for t in range(4)]
    left = []
    for pid in pids:
        try:
            os.kill(pid, 0)
            left.append(pid)
        except ProcessLookupError:
            pass
    check(not left, f"elastic: processes left behind {left}")
    check(_dmlc_shm() <= shm0,
          f"elastic: shm segments left {_dmlc_shm() - shm0}")
    # both resizes on every survivor, the joiner's one sync at world 3
    for t in (0, 1):
        worlds = [s["world"] for s in docs[t]["syncs"]]
        check(worlds == [3, 2, 3], f"elastic: task {t} syncs {worlds}")
        check(docs[t]["syncs"][1]["done"] == ELASTIC_SAVE_EVERY,
              f"elastic: shrink resynced at {docs[t]['syncs'][1]['done']}")
    check([s["world"] for s in docs[3]["syncs"]] == [3],
          f"elastic: joiner syncs {docs[3]['syncs']}")
    m = re.search(r'^dmlc_elastic_resizes_total\{rank="tracker"\} '
                  r'([0-9.eE+-]+)$', polls.last.get("/metrics", ""),
                  re.MULTILINE)
    check(m is not None and float(m.group(1)) >= 2,
          f"elastic: /metrics resizes {m and m.group(1)}")
    # every step's loss is one allreduced value on every rank that took it
    by_step = {}
    for d in docs.values():
        for step, (loss, verdict) in d["observed"].items():
            if verdict == "ok":
                by_step.setdefault(int(step), set()).add(loss)
    check(sorted(by_step) == list(range(1, ELASTIC_STEPS + 1))
          and all(len(v) == 1 for v in by_step.values()),
          f"elastic: losses disagree {by_step}")
    losses = [by_step[s].pop() for s in range(1, ELASTIC_STEPS + 1)]
    check(all(math.isfinite(x) for x in losses)
          and np.mean(losses[-10:]) < np.mean(losses[:10]),
          f"elastic: losses {losses}")
    check(len({d["sha256"] for d in docs.values()}) == 1,
          "elastic: final parameters differ between ranks")
    for t, d in docs.items():
        want = cfg.n_layers * d["loss_calls"]
        check(all(n == want for n in d["launches"].values()),
              f"elastic: task {t} launches {d['launches']} for "
              f"{d['loss_calls']} loss evaluations")
    # goodput: every second named, the episode attributed
    good = polls.last.get("/goodput") or {}
    cl = good.get("cluster", {})
    check(good.get("per_rank"), f"elastic: /goodput empty {good}")
    for doc in list(good["per_rank"].values()) + [cl]:
        check(abs(sum(doc["buckets"].values()) - doc["wall_s"])
              <= 0.02 * doc["wall_s"], f"elastic: goodput sums {doc}")
    check(cl["buckets"]["resize"] > 0
          and cl["buckets"]["checkpoint_restore"] > 0,
          f"elastic: unattributed episode {cl['buckets']}")
    check(cl["buckets"]["unattributed"] < 0.10 * cl["wall_s"],
          f"elastic: unattributed {cl['buckets']}")

    # the numbers: step p50 in each world from the survivors' ledgers,
    # the step that holds a resync left out
    def p50(lo, hi):
        walls = [r["wall_s"] for t in (0, 1) for r in docs[t]["records"]
                 if lo < r["t_wall"] <= hi]
        return median(walls) * 1e3 if walls else None

    shrink_done = max(docs[t]["syncs"][1]["t"] for t in (0, 1))
    grow_done = max(d["syncs"][-1]["t"] for d in docs.values())
    first_after = {
        name: min(r["t_wall"] for t in (0, 1) for r in docs[t]["records"]
                  if r["t_wall"] > at)
        for name, at in (("shrink", shrink_done), ("grow", grow_done))}
    restores = [s for d in docs.values() for s in d["syncs"]
                if s["rank"] == 0]
    with open(os.path.join(logs, "elastic_tracker_docs.json"), "w") as f:
        json.dump({"t_kill": t_kill, "flags": sorted(
            [list(k), v] for k, v in polls.flags.items()),
            "trace_reads": polls.trace_reads,
            **{p: polls.last.get(p) for p in TrackerPolls.PATHS
               if p != "/trace"}}, f)
    tracker_doc = tracker_docs_check(
        polls, docs, {t: d["syncs"][-1]["rank"] for t, d in docs.items()},
        t_kill, grow_done)
    led = docs[0]["ledger"]
    doc = {"phase": "elastic", "card": smi, "model": "flagship",
           "n_layers": cfg.n_layers, "params": tfm.count_params(cfg),
           "reduced": "depth 16 -> 1: each rank holds a full replica and "
                      "three share one card and the host; a resync "
                      "broadcasts params and both AdamW moments in "
                      "float64 (4.5 GB a rank at depth 1, 5.8 GB at 2, "
                      "24 GB at 16)",
           "workers": ELASTIC_WORKERS, "steps": ELASTIC_STEPS,
           "B": ex.PER_PART, "T": ex.SEQ, "env": ELASTIC_ENV,
           "step_p50_ms": {"world3": p50(0, t_kill),
                           "world2": p50(first_after["shrink"], t_grow),
                           "world3_again": p50(first_after["grow"],
                                               float("inf"))},
           "collective_exposed_fraction":
               led["collective_exposed_fraction"],
           "collective_overlapped_fraction":
               led["collective_overlapped_fraction"],
           "feed_wait_fraction": led["feed_wait_fraction"],
           "kill_to_first_step_s": first_after["shrink"] - t_kill,
           "shrink_settled_s": t_shrunk - t_kill,
           "resize_to_first_step_s": first_after["grow"] - t_grow,
           "syncs_rank0": [{k: s[k] for k in ("world", "done", "bytes",
                                               "restore_s", "broadcast_s")}
                           for s in restores],
           "goodput_fractions": {
               r: {b: v / d["wall_s"] for b, v in d["buckets"].items()}
               for r, d in good["per_rank"].items()},
           "goodput_cluster_fractions": cl["fractions"],
           "tracker": tracker_doc,
           "losses_first_last": [losses[0], losses[-1]],
           "launches": {n: sum(d["launches"][n] for d in docs.values())
                        for n in docs[0]["launches"]},
           "loss_calls": {t: d["loss_calls"] for t, d in docs.items()},
           "wall_s": wall}
    shutil.rmtree(root, ignore_errors=True)
    return doc, doc["launches"]


# ---------------------------------------------------------------------------
# phase 7d: the sharded flagship on a dp x sp x tp mesh
# ---------------------------------------------------------------------------

MESH_WORKERS = 4
MESH_SHAPE = {"dp": 1, "sp": 2, "tp": 2}
MESH_LAYERS = 2          # the flagship's widths at depth 2 (see the phase)
MESH_B, MESH_T = 2, 4096             # the train steps' global batch
MESH_CHECK_B, MESH_CHECK_T = 2, 2048  # the f32 gradient check's
MESH_RING = (1, 8192, 16, 128)       # ring attention alone: B, T, H, D
MESH_STEPS = 3
MESH_TIMEOUT_S = 420
MESH_LOSS_RTOL = 2e-5    # f32 sharded loss vs one process: sum order
MESH_GRAD_TOL = 1e-4     # max |g - g_ref| / max |g_ref| per leaf, f32
MESH_ENV = {"OMP_NUM_THREADS": "2"}
MESH_OPS = ("all_reduce", "all_gather", "reduce_scatter", "broadcast",
            "ppermute", "all_to_all")


GLOO_PROBE_OPS = ("all_reduce", "all_reduce_async", "all_gather_into_tensor",
                  "reduce_scatter_tensor", "all_to_all_single", "broadcast",
                  "batch_isend_irecv")


def gloo_probe_worker(argv) -> int:
    """One of two ranks that share the card over gloo: each op the mesh
    hands gloo, once on a CUDA tensor and held to its closed form,
    point-to-point last (a refusal there closes the pair).  Writes
    ``{op: "ok" | "wrong" | "refused: ..."}`` to ``<out>/gloo.<rank>.json``
    after each op."""
    import datetime
    import torch.distributed as dist

    rank, port, out_dir = int(argv[0]), argv[1], argv[2]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda", 0)
    x = torch.full((4, 3), float(rank + 1), device=dev)
    rows = torch.arange(4.0, device=dev)[:, None].repeat(1, 3)

    def run(op):
        if op == "all_reduce":
            y = x.clone()
            dist.all_reduce(y)
            return y, torch.full_like(x, 3.0)
        if op == "all_reduce_async":   # overlap="device"'s buckets
            y = x.clone()
            work = dist.all_reduce(y, async_op=True)
            work.wait()
            return y, torch.full_like(x, 3.0)
        if op == "all_gather_into_tensor":
            y = x.new_empty((8, 3))
            dist.all_gather_into_tensor(y, x)
            return y, torch.cat([torch.full_like(x, 1.0),
                                 torch.full_like(x, 2.0)])
        if op == "reduce_scatter_tensor":
            y = x.new_empty((2, 3))
            dist.reduce_scatter_tensor(y, x)
            return y, torch.full_like(y, 3.0)
        if op == "all_to_all_single":
            y = torch.empty_like(rows)
            dist.all_to_all_single(y, rows + 10 * rank)
            mine = rows[2 * rank:2 * rank + 2]
            return y, torch.cat([mine, mine + 10])
        if op == "broadcast":
            y = x.clone()
            dist.broadcast(y, 1)
            return y, torch.full_like(x, 2.0)
        y = torch.empty_like(x)
        for req in dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, x, 1 - rank),
                 dist.P2POp(dist.irecv, y, 1 - rank)]):
            req.wait()
        return y, torch.full_like(x, 2.0 - rank)

    doc = {}
    for op in GLOO_PROBE_OPS:
        try:
            got, want = run(op)
            torch.cuda.synchronize()
            doc[op] = "ok" if torch.equal(got, want) else "wrong"
        except Exception as e:  # noqa: BLE001 - the refusal is the result
            doc[op] = f"refused: {type(e).__name__}: " \
                      f"{str(e).splitlines()[0][:200]}"
        with open(os.path.join(out_dir, f"gloo.{rank}.json"), "w") as f:
            json.dump(doc, f)
    sys.stdout.flush()
    os._exit(0)   # a refused pair can hang the group's teardown


def gloo_probe_start(root):
    """Start the two ranks of :func:`gloo_probe_worker` in a session of
    their own; returns them for :func:`gloo_probe_finish`."""
    import socket

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--gloo-probe",
         str(r), str(port), root], cwd=ROOT, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        start_new_session=True) for r in range(2)]


def gloo_probe_finish(procs, root):
    """Wait for the probe's ranks (killed at 120 s), log them to
    ``chiprun_out/gloo_probe.log`` and return each op's verdict: "ok"
    on both ranks, else the first rank's refusal, or what ended a rank
    that died in the op (gloo aborts the process from its transport
    thread)."""
    outs, docs = [], []
    for r, proc in enumerate(procs):
        try:
            out, _ = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            out, _ = proc.communicate()
        outs.append(f"exit {proc.returncode}\n{out}")
        path = os.path.join(root, f"gloo.{r}.json")
        doc = json.load(open(path)) if os.path.exists(path) else {}
        what = [ln.split("what():", 1)[1].strip()
                for ln in out.splitlines() if "what():" in ln]
        died = next((op for op in GLOO_PROBE_OPS if op not in doc), None)
        if died is not None:
            doc[died] = (f"aborted (exit {proc.returncode}): "
                         f"{what[0] if what else out.strip()[-200:]}")
        docs.append(doc)
    shutil.rmtree(root, ignore_errors=True)
    verdict = {}
    for op in GLOO_PROBE_OPS:
        bad = [d.get(op, "no answer") for d in docs
               if d.get(op) != "ok"]
        verdict[op] = "ok" if not bad else next(
            (b for b in bad if not b.startswith("no answer")), bad[0])
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "gloo_probe.log"), "w") as f:
        f.write(json.dumps({"torch": torch.__version__, "ranks": docs,
                            "verdict": verdict}, indent=1) + "\n")
        f.write("\n".join(outs))
    return verdict


def mesh_config_():
    from dmlc_tpu_torch.models import transformer as tfm

    return dataclasses.replace(tfm.flagship_config(), n_layers=MESH_LAYERS)


def ring_step_rows(fa):
    """K1 at the mesh train step's ring-step shape (B=2, T_local=2048, 8
    local heads, D=128, bf16) at rank 1's offsets: its own block (the
    diagonal, causal) and rank 0's block (fully visible).  Held against
    the plain version (pv, m, l; o = pv / l within the bf16 tolerances),
    timed beside the plain version and SDPA on the same q/k/v (causal /
    not; normalised output, a yardstick)."""
    cfg = mesh_config_()
    gen = torch.Generator("cuda").manual_seed(9)
    b, t = MESH_B, MESH_T // MESH_SHAPE["sp"]
    h, d = cfg.n_heads // MESH_SHAPE["tp"], cfg.head_dim
    q, k, v = (torch.randn((b, t, h, d), generator=gen,
                           device="cuda").to(torch.bfloat16)
               for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    rows = {}
    for name, kv_off, pairs in (("diagonal", t, t * (t + 1) // 2),
                                ("visible", 0, t * t)):
        kw = dict(scale=d ** -0.5, causal=True, q_offset=t, kv_offset=kv_off)
        pv, m, l = fa.block_attend(q, k, v, **kw)
        pv_r, m_r, l_r = fa.block_attend(q, k, v, impl="torch", **kw)
        torch.cuda.synchronize()
        o = pv / l.transpose(1, 2)[..., None]
        o_r = pv_r / l_r.transpose(1, 2)[..., None]
        mx, mean = errors(o, o_r)
        e_ml = max(errors(m, m_r)[0],
                   ((l - l_r).abs() / l_r.clamp_min(1.0)).max().item())
        check(mx <= BF16_TOL[0] and mean <= BF16_TOL[1] and e_ml <= F32_TOL,
              f"ring step {name}: {mx} {mean} {e_ml}")
        del pv, m, l, pv_r, m_r, l_r, o, o_r
        flops = 4.0 * d * b * h * pairs
        # q, k, v read (bf16); pv (f32), m and l (f32) written once
        nbytes = 3 * q.numel() * 2 + q.numel() * 4 + 2 * b * h * t * 4
        bnd, by = bound_ms(flops, nbytes, torch.bfloat16)
        causal = name == "diagonal"
        rows[name] = {
            "B": b, "T_local": t, "H_local": h, "D": d, "dtype": "bfloat16",
            "q_offset": t, "kv_offset": kv_off, "max_abs_err": mx,
            "mean_abs_err": mean, "m_l_err": e_ml,
            "ms": time_ms(lambda: fa.block_attend(q, k, v, **kw)),
            "plain_ms": time_ms(lambda: fa.block_attend(q, k, v,
                                                        impl="torch", **kw),
                                iters=5),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal)),
            "library": f"SDPA {'causal' if causal else 'non-causal'} "
                       "(normalised output)",
            "bound_ms": bnd, "bound_by": by}
        rows[name]["bound_share"] = bnd / rows[name]["ms"]
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return rows


def _leaf_sha(model, mesh):
    """{leaf name: (shard key, SHA-256)}: the shard key names which ranks
    hold the same values (replicated leaves: every rank)."""
    import hashlib

    from dmlc_tpu_torch.models.transformer import sharded_axes

    out = {}
    for name, prm in model.named_parameters():
        key = [mesh.axis_rank(a) for a in sharded_axes(name)
               if mesh.axis_size(a) > 1]
        out[name] = (key, hashlib.sha256(
            prm.detach().float().cpu().numpy().tobytes()).hexdigest())
    return out


def mesh_collective_checks(mesh):
    """Every named collective once on CUDA tensors over the sp and tp
    axes, held to its closed form (the gate for the ops gloo runs on the
    card directly and for the staged ppermute); returns the ops' names."""
    from dmlc_tpu_torch.parallel import collectives as coll

    done = []
    for axis in ("sp", "tp"):
        n, i = mesh.axis_size(axis), mesh.axis_rank(axis)
        base = torch.arange(4 * n, dtype=torch.float32,
                            device=mesh.device).reshape(n, 4)
        x = base + 100 * i            # rank r of the axis holds base + 100 r
        total = n * base + 100 * sum(range(n))
        want = {
            "all_reduce": total,
            "all_reduce_max": base + 100 * (n - 1),
            "all_gather": torch.cat([base + 100 * r for r in range(n)]),
            "reduce_scatter": total[i:i + 1],
            "broadcast": base + 100 * (n - 1),
            "ppermute": base + 100 * ((i - 1) % n),
            "all_to_all": torch.cat([(base + 100 * r)[i:i + 1]
                                     for r in range(n)]),
        }
        got = {
            "all_reduce": coll.all_reduce(x, axis, mesh=mesh),
            "all_reduce_max": coll.all_reduce(x, axis, "max", mesh=mesh),
            "all_gather": coll.all_gather(x, axis, mesh=mesh),
            "reduce_scatter": coll.reduce_scatter(x, axis, mesh=mesh),
            "broadcast": coll.broadcast(x, axis, n - 1, mesh=mesh),
            "ppermute": coll.ppermute_ring(x, axis, mesh=mesh),
            "all_to_all": coll.all_to_all(x, axis, split_axis=0,
                                          concat_axis=0, mesh=mesh),
        }
        for op, g in got.items():
            check(g.device == mesh.device and torch.equal(g, want[op]),
                  f"mesh: {op} over {axis}: {g} != {want[op]}")
        check(coll.barrier_sum(axis, mesh=mesh) == n, f"barrier_sum {axis}")
        done = sorted(got) + ["barrier_sum"]
    return done


def mesh_worker(argv) -> int:
    """One rank of the mesh phase (under the port's launcher): tracker
    rendezvous, ``initialize_distributed()``, ``build_mesh(dp=1, sp=2,
    tp=2)``; then ring attention alone, Ulysses, the f32 gradient check
    and the bf16 train steps, each held to its reference.  Writes its
    numbers to ``<out>/mesh.<rank>.json``."""
    sys.path.insert(0, ROOT)
    from dmlc_tpu_torch import telemetry as tele
    from dmlc_tpu_torch.models import transformer as tfm
    from dmlc_tpu_torch.models.convert import (gather_params,
                                               shard_params_from_jax)
    from dmlc_tpu_torch.ops import flash_attention as fa
    from dmlc_tpu_torch.ops import paged_attention as pa
    from dmlc_tpu_torch.parallel import build_mesh, initialize_distributed
    from dmlc_tpu_torch.parallel.ring_attention import \
        make_sharded_ring_attention
    from dmlc_tpu_torch.parallel.ulysses import ulysses_attention
    from dmlc_tpu_torch.tracker.client import TrackerClient
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = argv[0]
    with open(os.path.join(out_dir, "config.json")) as f:
        conf = json.load(f)
    client = TrackerClient()
    client.start()
    t0 = time.perf_counter()
    backend = initialize_distributed(timeout_s=MESH_TIMEOUT_S)
    mesh = build_mesh(**conf["mesh"])
    rank = mesh.rank
    doc = {"rank": rank, "coords": mesh.coords, "backend": backend,
           "device": str(mesh.device), "init_s": time.perf_counter() - t0}
    kernels = {"flash_fwd": fa.FLASH_FWD, "flash_bwd_dkv": fa.FLASH_BWD_DKV,
               "flash_bwd_dq": fa.FLASH_BWD_DQ,
               "paged_attention": pa.PAGED_ATTENTION}

    def zero():
        for kern in kernels.values():
            kern.launches = 0

    def counts():
        return {n: kern.launches for n, kern in kernels.items()}

    doc["collectives"] = mesh_collective_checks(mesh)
    sp, tp = mesh.axis_size("sp"), mesh.axis_size("tp")
    si, ti = mesh.axis_rank("sp"), mesh.axis_rank("tp")

    def block(x):   # this rank's (sp sequence, tp heads) block
        return x.chunk(sp, dim=1)[si].chunk(tp, dim=2)[ti]

    def heads(x):
        return x.chunk(tp, dim=2)[ti]

    def seq(x):
        return x.chunk(sp, dim=1)[si]

    # 2. ring attention alone, 3. Ulysses: against flash_attention on the
    # gathered sequence (this rank's heads), output and q/k/v gradients
    gen = torch.Generator("cuda").manual_seed(11)
    q, k, v, w = (torch.randn(conf["ring"], generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(4))
    ref = [heads(x).detach().clone().requires_grad_(True) for x in (q, k, v)]
    o_ref = fa.flash_attention(*ref, causal=True)
    (o_ref.float() * heads(w).float()).sum().backward()
    ref_out = {"o": seq(o_ref.detach()),
               **{f"d{n}": seq(t.grad) for n, t in zip("qkv", ref)}}
    del ref, o_ref
    ring = make_sharded_ring_attention(mesh, causal=True)

    def attn_case(name, run):
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        dist.barrier()
        zero()
        o = run(*leaves)
        torch.cuda.synchronize()
        fwd = counts()
        (o.float() * block(w).float()).sum().backward()
        torch.cuda.synchronize()
        total = counts()
        errs = {"o": errors(o, ref_out["o"])}
        for n, t in zip("qkv", leaves):
            errs[f"d{n}"] = rel_norm(block(t.grad), ref_out[f"d{n}"])
        check(errs["o"][0] <= BF16_TOL[0] and errs["o"][1] <= BF16_TOL[1],
              f"mesh {name}: output error {errs['o']}")
        for n in ("dq", "dk", "dv"):
            check(errs[n] <= GRAD_TOL[torch.bfloat16],
                  f"mesh {name}: {n} rel err {errs[n]}")
        walls = []
        for _ in range(3):
            dist.barrier()
            torch.cuda.synchronize()
            ts = time.perf_counter()
            with torch.no_grad():
                run(*leaves)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - ts) * 1e3)
        return {"errors": errs, "fwd_launches": fwd, "launches": total,
                "fwd_ms_p50": median(walls), "fwd_ms": walls}

    doc["ring"] = attn_case("ring", ring)
    check(doc["ring"]["fwd_launches"]["flash_fwd"] == sp,
          f"ring: K1 launches {doc['ring']['fwd_launches']} != sp={sp}")
    doc["ulysses"] = attn_case("ulysses", lambda a, b, c: ulysses_attention(
        block(a), block(b), block(c), mesh=mesh, causal=True,
        attn_fn=lambda q_, k_, v_, causal: fa.flash_attention(
            q_, k_, v_, causal=causal)))
    del q, k, v, w, ref_out
    torch.cuda.empty_cache()

    # 4. f32 at depth 2: sharded loss and every gathered gradient against
    # one process's unsharded_loss on the same weights
    cfg = tfm.TransformerConfig(**conf["model"])
    dp = mesh.axis_size("dp")

    def local(x):
        return (x.chunk(dp, 0)[mesh.axis_rank("dp")].chunk(sp, 1)[si])

    doc["f32"] = mesh_f32_check(tfm, mesh, cfg, conf, local, "mesh")

    # 5. bf16 AdamW steps through make_train_step(mesh=...)
    glob = tfm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                           "cuda")
    model = shard_params_from_jax(gather_params(glob), cfg, mesh)
    del glob
    torch.cuda.empty_cache()
    doc["params_local"] = sum(p.numel() for p in model.parameters())
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (conf["B"], conf["T"] + 1))).cuda()
    step = tfm.make_train_step(model, tfm.adamw(model.parameters(), 1e-4),
                               ledger=False, mesh=mesh)
    tele.reset()
    losses, walls = [float(step(ids[:, :-1], ids[:, 1:]))], []  # warm-up
    torch.cuda.synchronize()
    dist.barrier()
    zero()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(conf["steps"]):
        ts = time.perf_counter()
        losses.append(float(step(ids[:, :-1], ids[:, 1:])))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - ts) * 1e3)
    doc["train"] = {
        "losses": losses, "step_ms": walls, "step_p50_ms": median(walls),
        "launches": counts(), "peak_gb": torch.cuda.max_memory_allocated()
        / 1e9,
        "staged_bytes_per_step": {"ppermute": tele.core.counter_value(
            "collective", "ppermute_staged_bytes") / (conf["steps"] + 1)},
        "bytes_per_step": {
            op: tele.core.counter_value("collective", f"{op}_bytes")
            / (conf["steps"] + 1) for op in MESH_OPS},
        "ring_bytes_rotated_per_step": tele.core.counter_value(
            "ring_attention", "bytes_rotated") / (conf["steps"] + 1)}
    doc["sha256"] = _leaf_sha(model, mesh)
    doc["wall_s"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"mesh.{rank}.json"), "w") as f:
        json.dump(doc, f)
    client.log(f"rank {rank}: mesh phase done")
    dist.destroy_process_group()
    client.shutdown()
    return 0


def mesh_job(name, flag, conf, timeout, root=None, log_dir=None,
             env=MESH_ENV):
    """``MESH_WORKERS`` workers of the port's launcher sharing the card,
    each ``chip_smoke.py <flag> <root>`` (with ``env``; ``root`` defaults
    to ``build/<name>``), given ``conf`` as ``config.json``; returns the
    ranks' ``<name>.<rank>.json`` docs and the job's seconds.  ``root``
    is removed after; the job's log goes to ``log_dir`` (see
    :func:`_submit`)."""
    root = root or os.path.join(ROOT, "build", name)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(dict(conf, ckpt=os.path.join(root, "ckpt")), f)
    env_old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        _, _, job_s = _submit(
            name, [sys.executable, os.path.join(ROOT, "chip_smoke.py"), flag,
                   root], timeout, workers=MESH_WORKERS, log_dir=log_dir)
    finally:
        for k, v in env_old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    docs = [json.load(open(os.path.join(root, f"{name}.{r}.json")))
            for r in range(MESH_WORKERS)]
    shutil.rmtree(root, ignore_errors=True)
    return docs, job_s


def mesh_phase(smi, fa):
    """The sharded flagship (see the module docstring): the psum worker,
    then 4 mesh workers under the port's launcher sharing the card.
    Returns the phase's line, the K1 ring-step rows and the kernels'
    launches summed over the ranks' ring, Ulysses and train runs."""
    t_start = time.time()
    rows = ring_step_rows(fa)
    probe_root = os.path.join(ROOT, "build", "gloo_probe")
    probe = gloo_probe_start(probe_root)
    try:
        out, err, psum_s = _submit(
            "mesh_psum", [sys.executable, "-m",
                          "dmlc_tpu_torch.examples.psum_worker"], 300,
            workers=MESH_WORKERS)
    finally:
        gloo_cuda = gloo_probe_finish(probe, probe_root)
    # every op the port hands gloo on a CUDA tensor as it is: all but
    # point-to-point, which collectives._shift stages through host memory
    for op in GLOO_PROBE_OPS[:-1]:
        check(gloo_cuda[op] == "ok", f"mesh: gloo on a CUDA tensor, {op}: "
              f"{gloo_cuda[op]} (chiprun_out/gloo_probe.log)")
    want = MESH_WORKERS * (MESH_WORKERS + 1) / 2
    for r in range(MESH_WORKERS):
        check(f"rank {r}/{MESH_WORKERS}: torch psum OK -> {want}"
              in out + err, f"mesh: psum rank {r} (tracker_mesh_psum.log)")
    cfg = mesh_config_()
    docs, job_s = mesh_job("mesh", "--mesh-worker", {
        "mesh": MESH_SHAPE, "ring": MESH_RING,
        "model": dataclasses.asdict(cfg), "B": MESH_B, "T": MESH_T,
        "check_B": MESH_CHECK_B, "check_T": MESH_CHECK_T,
        "steps": MESH_STEPS}, MESH_TIMEOUT_S)
    backends = {d["backend"] for d in docs}
    check(len(backends) == 1, f"mesh: backends {backends}")
    losses = [d["train"]["losses"] for d in docs]
    check(all(ls == losses[0] for ls in losses),
          f"mesh: ranks disagree on the losses {losses}")
    check(all(math.isfinite(x) for x in losses[0])
          and losses[0][-1] < losses[0][0], f"mesh: losses {losses[0]}")
    for name in docs[0]["sha256"]:
        held = {}
        for d in docs:
            key, sha = d["sha256"][name]
            held.setdefault(tuple(key), set()).add(sha)
        check(all(len(v) == 1 for v in held.values()),
              f"mesh: {name} differs between ranks that hold it")
    per_step = [{n: c / MESH_STEPS
                 for n, c in d["train"]["launches"].items()}
                for d in docs]
    launches = {n: sum(d[part]["launches"][n]
                       for d in docs for part in ("ring", "ulysses", "train"))
                for n in docs[0]["train"]["launches"]}
    line = {
        "phase": "mesh", "card": smi, "backend": docs[0]["backend"],
        "gloo_cuda": {"torch": torch.__version__, **gloo_cuda},
        "mesh": MESH_SHAPE, "workers": MESH_WORKERS, "model": "flagship",
        "n_layers": cfg.n_layers,
        "reduced": "depth 16 -> 2: four ranks share one card and the host, "
                   "and every tp activation and (dp, sp) gradient crosses "
                   "gloo through host memory",
        "B": MESH_B, "T": MESH_T, "T_local": MESH_T // MESH_SHAPE["sp"],
        "params_local": [d["params_local"] for d in docs],
        "init_s": [d["init_s"] for d in docs],
        "collectives_checked": docs[0]["collectives"],
        "ring": {"shape": MESH_RING,
                 "fwd_ms_p50": [d["ring"]["fwd_ms_p50"] for d in docs],
                 "k1_launches_per_call": docs[0]["ring"]["fwd_launches"][
                     "flash_fwd"],
                 "errors": [d["ring"]["errors"] for d in docs]},
        "ulysses": {"fwd_ms_p50": [d["ulysses"]["fwd_ms_p50"] for d in docs],
                    "launches": [d["ulysses"]["launches"] for d in docs],
                    "errors": [d["ulysses"]["errors"] for d in docs]},
        "f32_check": [d["f32"] for d in docs],
        "losses": losses[0],
        "step_p50_ms": [d["train"]["step_p50_ms"] for d in docs],
        "step_ms": [d["train"]["step_ms"] for d in docs],
        "peak_gb": [d["train"]["peak_gb"] for d in docs],
        "launches_per_step_per_rank": per_step,
        "staged_bytes_per_step": docs[0]["train"]["staged_bytes_per_step"],
        "collective_bytes_per_step": docs[0]["train"]["bytes_per_step"],
        "ring_bytes_rotated_per_step": docs[0]["train"][
            "ring_bytes_rotated_per_step"],
        "ring_step_k1": rows, "psum_s": psum_s, "job_s": job_s,
        "wall_s": time.time() - t_start}
    check(all(c["flash_fwd"] > 0 for c in per_step),
          f"mesh: K1 never ran on a step {per_step}")
    return line, rows, launches


# ---------------------------------------------------------------------------
# phase 7e: the rest of the five-axis mesh — the pipeline, expert
# parallelism, the bucketed device reduction, sharded checkpoints
# ---------------------------------------------------------------------------

#: gang A: the dense flagship's widths on pp2 x dp2 (2 layers a stage, 2
#: microbatches, B=8 x T=1024: one microbatch is [2, 1024, 16, 128] for
#: K1 on a dp rank); gang B: the routed flagship (top-2 of 8) on ep2 x
#: tp2 (4 experts x half of d_ff and 8 heads a rank, B=2 x T=2048)
MESH5_GANGS = {
    "A": {"mesh": {"pp": 2, "dp": 2, "sp": 1, "ep": 1, "tp": 1},
          "n_layers": 2, "microbatches": 2, "routed": False,
          "B": 8, "T": 1024, "check_B": 4, "check_T": 1024,
          "overlaps": [None, "device"], "checkpoint": True},
    "B": {"mesh": {"pp": 1, "dp": 1, "sp": 1, "ep": 2, "tp": 2},
          "n_layers": 2, "microbatches": 1, "routed": True,
          "B": 2, "T": 2048, "check_B": 2, "check_T": 2048,
          "overlaps": [None], "checkpoint": False},
}
MESH5_STEPS = 3
MESH5_TIMEOUT_S = 480
#: overlap="device" against the fused reduction, bf16 losses: the
#: bucket sums and the loss's transpose differ by a division by dp=2,
#: exact in bf16, so the bits should agree; the losses' gate allows bf16
#: rounding, the leaves after the steps are gated bit-equal
MESH5_OVERLAP_RTOL = 1e-2


def mesh5_config(gang):
    """The gang's bf16 config: the flagship's widths at the gang's depth
    and microbatches, routed top-2 of 8 for gang B."""
    from dmlc_tpu_torch.models import transformer as tfm

    g = MESH5_GANGS[gang]
    cfg = dataclasses.replace(tfm.flagship_config(), n_layers=g["n_layers"],
                              microbatches=g["microbatches"])
    return moe_config(cfg) if g["routed"] else cfg


def mesh_f32_check(tfm, mesh, cfg, conf, local, phase):
    """``cfg`` at depth 2 in float32 on the mesh against one process's
    ``unsharded_loss`` on the same weights (B x T = ``conf``'s
    ``check_B`` x ``check_T``, this rank's block taken by ``local``):
    the loss within ``MESH_LOSS_RTOL`` relative, every gathered gradient
    within ``MESH_GRAD_TOL`` of its max; for a routed config, the share
    of (token, layer, choice) routes that agree."""
    from dmlc_tpu_torch.models.convert import (gather_params,
                                               shard_params_from_jax)

    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg32.vocab, (
        conf["check_B"], conf["check_T"] + 1))).cuda()
    x_ids, y_ids = ids[:, :-1], ids[:, 1:]
    glob = tfm.init_params(cfg32, torch.Generator("cuda").manual_seed(0),
                           "cuda")
    model = shard_params_from_jax(gather_params(glob), cfg32, mesh)
    # the routes of the forward (a remat recompute in the backward
    # records them again, after)
    routes, ref_routes = [], []
    undo = _record_routes(model, routes)
    loss = tfm.forward_local(model, local(x_ids), local(y_ids), cfg32,
                             tfm.SHARDED_AXES, mesh)
    n_fwd = len(routes)
    loss.backward()
    undo()
    del routes[n_fwd:]
    tfm.sync_gradients(model, mesh)
    grads = gather_params(model, mesh, grads=True)
    del model
    undo = _record_routes(glob, ref_routes)
    ref_loss = tfm.unsharded_loss(glob, x_ids, y_ids)
    n_fwd = len(ref_routes)
    ref_loss.backward()
    undo()
    del ref_routes[n_fwd:]
    ref_grads = gather_params(glob, grads=True)

    def leaves(tree):
        out = {n: tree[n] for n in ("embed", "unembed", "ln_f")}
        out.update({n: g.flatten(0, 1) for n, g in tree["blocks"].items()})
        return out

    flat, flat_ref = leaves(grads), leaves(ref_grads)
    loss, ref_loss = float(loss), float(ref_loss)
    rel_loss = abs(loss - ref_loss) / abs(ref_loss)
    worst = {n: ((g - flat_ref[n]).abs().max()
                 / flat_ref[n].abs().max().clamp_min(1e-30)).item()
             for n, g in flat.items()}
    doc = {"loss": loss, "ref_loss": ref_loss,
           "loss_rel_err": rel_loss, "grad_rel_max_err": worst,
           "B": conf["check_B"], "T": conf["check_T"]}
    if cfg.routed:
        # every rank routes all of its (dp, sp) block's tokens, here all
        doc["route_agreement"] = torch.cat(
            [(a == b).float().reshape(-1) for a, b in
             zip(routes, ref_routes)]).mean().item()
    check(rel_loss <= MESH_LOSS_RTOL, f"{phase} f32 loss: rel {rel_loss}")
    check(max(worst.values()) <= MESH_GRAD_TOL,
          f"{phase} f32 gradients: {worst}")
    del glob, grads, ref_grads
    torch.cuda.empty_cache()
    return doc


def _span_s(tele, after, name):
    """Seconds in the spans called ``name`` recorded after ``after``."""
    return sum(s["dur"] for s in tele.core.spans_since(after)[0]
               if s["name"] == name) / 1e6


def mesh5_worker(argv) -> int:
    """One rank of the ``mesh5`` job (under the port's launcher): tracker
    rendezvous, ``initialize_distributed()``, then each gang of
    ``conf["gangs"]`` on its own ``build_mesh`` over the same 4 ranks
    (:func:`mesh5_gang`).  Writes ``<out>/mesh5.<rank>.json``."""
    sys.path.insert(0, ROOT)
    from dmlc_tpu_torch.parallel import initialize_distributed
    from dmlc_tpu_torch.tracker.client import TrackerClient
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = argv[0]
    with open(os.path.join(out_dir, "config.json")) as f:
        conf = json.load(f)
    client = TrackerClient()
    client.start()
    t0 = time.perf_counter()
    backend = initialize_distributed(timeout_s=MESH5_TIMEOUT_S)
    docs = {gang: mesh5_gang(dict(g, ckpt=conf["ckpt"]), backend)
            for gang, g in conf["gangs"].items()}
    docs["wall_s"] = time.perf_counter() - t0
    rank = dist.get_rank()
    with open(os.path.join(out_dir, f"mesh5.{rank}.json"), "w") as f:
        json.dump(docs, f)
    client.log(f"rank {rank}: mesh5 gangs done")
    dist.destroy_process_group()
    client.shutdown()
    return 0


def mesh5_gang(conf, backend):
    """One gang of the mesh5 job on this rank: ``build_mesh`` of the
    gang's shape; the f32 check, then the bf16 AdamW steps of each
    overlap mode from one start, gang A's sharded checkpoint and its
    restored step, gang B's dropped-choice fraction.  Returns its
    numbers."""
    from dmlc_tpu_torch import telemetry as tele
    from dmlc_tpu_torch.checkpoint import restore_pytree, save_pytree
    from dmlc_tpu_torch.models import transformer as tfm
    from dmlc_tpu_torch.models.convert import (
        gather_params, shard_params_from_jax, state_specs,
        train_state_from_jax, train_state_to_jax)
    from dmlc_tpu_torch.ops import flash_attention as fa
    from dmlc_tpu_torch.parallel import build_mesh
    import torch.distributed as dist

    t0 = time.perf_counter()
    mesh = build_mesh(**conf["mesh"])
    rank = mesh.rank
    doc = {"rank": rank, "coords": mesh.coords, "backend": backend,
           "groups": sorted("+".join(k) if isinstance(k, tuple) else k
                            for k in mesh.groups),
           "init_s": time.perf_counter() - t0}
    kernels = {"flash_fwd": fa.FLASH_FWD, "flash_bwd_dkv": fa.FLASH_BWD_DKV,
               "flash_bwd_dq": fa.FLASH_BWD_DQ}

    def zero():
        for kern in kernels.values():
            kern.launches = 0

    def counts():
        return {n: kern.launches for n, kern in kernels.items()}

    dp, sp = mesh.axis_size("dp"), mesh.axis_size("sp")

    def local(x):
        return (x.chunk(dp, 0)[mesh.axis_rank("dp")]
                .chunk(sp, 1)[mesh.axis_rank("sp")])

    cfg = tfm.TransformerConfig(**conf["model"])
    doc["f32"] = mesh_f32_check(tfm, mesh, cfg, conf, local, "mesh5")

    # bf16 AdamW steps of each overlap mode from one start
    glob = tfm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                           "cuda")
    tree = gather_params(glob)
    del glob
    torch.cuda.empty_cache()
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (conf["B"], conf["T"] + 1))).cuda()
    x_ids, y_ids = ids[:, :-1], ids[:, 1:]
    doc["train"] = {}
    keep = None
    for overlap in conf["overlaps"]:
        model = shard_params_from_jax(tree, cfg, mesh)
        opt = tfm.adamw(model.parameters(), 1e-4)
        step = tfm.make_train_step(model, opt, ledger=False, mesh=mesh,
                                   overlap=overlap)
        doc["params_local"] = sum(p.numel() for p in model.parameters())
        tele.reset()
        losses = [float(step(x_ids, y_ids))]       # warm-up
        torch.cuda.synchronize()
        dist.barrier()
        zero()
        tele.reset()
        seq = tele.core.span_seq()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(conf["steps"]):
            ts = time.perf_counter()
            losses.append(float(step(x_ids, y_ids)))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - ts) * 1e3)
        coll = tele.snapshot()["counters"].get("collective", {})
        n = conf["steps"]
        doc["train"][str(overlap)] = {
            "losses": losses, "step_ms": walls, "step_p50_ms": median(walls),
            "launches": counts(),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "staged_bytes_per_step":
                coll.get("ppermute_staged_bytes", 0.0) / n,
            "all_reduce_bytes_per_step":
                coll.get("all_reduce_bytes", 0.0) / n,
            "buckets_per_step": coll.get("overlap_buckets", 0.0) / n,
            # the host's wait on the (dp, sp) reduction a step: the fused
            # all-reduce after the backward, or the join on the buckets
            "exposed_s_per_step": _span_s(
                tele, seq, "collective.join" if overlap
                else "collective.allreduce") / n}
        entry = doc["train"][str(overlap)]
        entry["sha256"] = _leaf_sha(model, mesh)
        if overlap is None:
            keep = (model, opt, step)
        else:
            # the same steps from the same start: the bucketed means are
            # the fused ones, so every leaf should come out bit-equal
            entry["leaves_equal_to_fused"] = all(
                torch.equal(a, b) for a, b in zip(model.parameters(),
                                                  keep[0].parameters()))
            del model, opt, step
        torch.cuda.empty_cache()
    model, opt, step = keep
    del tree
    doc["sha256"] = doc["train"]["None"]["sha256"]

    if conf["checkpoint"]:
        # the train state after the steps, sharded with specs; restored
        # into a fresh model and AdamW; one more step from each
        dist.barrier()
        ts = time.perf_counter()
        state = train_state_to_jax(model, opt)
        nbytes = save_pytree(conf["ckpt"], state, mesh=mesh,
                             specs=state_specs(state))
        save_s = time.perf_counter() - ts
        del state
        fresh = tfm.Transformer(cfg, mesh=mesh)
        fresh_opt = tfm.adamw(fresh.parameters(), 1e-4)
        dist.barrier()
        ts = time.perf_counter()
        back = restore_pytree(conf["ckpt"], train_state_to_jax(
            fresh, fresh_opt, device="meta"), mesh=mesh)
        train_state_from_jax(back, fresh, fresh_opt)
        del back
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - ts
        restored = _leaf_sha(fresh, mesh)
        fresh_step = tfm.make_train_step(fresh, fresh_opt, ledger=False,
                                         mesh=mesh)
        after = [float(step(x_ids, y_ids)), float(fresh_step(x_ids, y_ids))]
        doc["checkpoint"] = {
            "bytes_written": nbytes, "save_s": save_s, "restore_s": restore_s,
            "restored_equal": restored == doc["sha256"],
            "step_losses": after,
            "step_sha_equal": _leaf_sha(fresh, mesh) == _leaf_sha(model,
                                                                  mesh)}
        del fresh, fresh_opt, fresh_step

    if cfg.routed:
        # the dropped-choice fraction of this rank's own choices, one call
        tele.reset()
        debug = dataclasses.replace(cfg, moe_debug_overflow=True)
        with torch.no_grad():
            tfm.forward_local(model, local(x_ids), local(y_ids), debug,
                              tfm.SHARDED_AXES, mesh)
        moe = tele.snapshot()["counters"]["moe"]
        doc["overflow_fraction"] = (moe["overflow_fraction_sum"]
                                    / moe["overflow_checks"])
    del model, opt, step, keep
    gc.collect()
    torch.cuda.empty_cache()
    doc["wall_s"] = time.perf_counter() - t0
    return doc


def mesh5_kernel_rows(fa):
    """K1, K2 and K3 alone at the two gangs' shapes (gang A's microbatch
    [2, 1024, 16, 128], gang B's [2, 2048, 8, 128]; bf16, causal): K1
    held against the plain forward, K2 and K3 against the plain backward
    at ``GRAD_TOL`` (:func:`bwd_check`); K1 timed beside the plain
    forward and SDPA, with its bound.  Returns K1's rows, each with K2's
    and K3's errors at its shape."""
    rows = {}
    gen = torch.Generator("cuda").manual_seed(13)
    for name, (b, t, h, d) in (("gang_A", (2, 1024, 16, 128)),
                               ("gang_B", (2, 2048, 8, 128))):
        args = bwd_inputs(gen, b, t, h, d, torch.bfloat16, True)
        mx, _ = fwd_check(fa, *args[:4])
        bwd = bwd_check(fa, args, {"phase": "mesh5_bwd", "gang": name,
                                   "dtype": "bfloat16", "B": b, "T": t,
                                   "H": h, "D": d, "causal": True})
        torch.cuda.empty_cache()
        rows[name] = dict(fwd_timing(fa, *args[:3], b, t, h, d,
                                     phase="mesh5_k1"), max_abs_err=mx,
                          bwd={k: v for k, v in bwd.items()
                               if k.endswith("_err")})
        del args
        torch.cuda.empty_cache()
    return rows


def mesh5_phase(smi, fa):
    """The rest of the five-axis mesh (see the module docstring): K1 at
    the gangs' shapes, gang A (the pipeline, dp, overlap="device", the
    sharded checkpoint) and gang B (routed experts over ep x tp).  Returns
    the phase's line, the K1 rows and the kernels' launches summed over
    the gangs' ranks' timed steps."""
    t_start = time.time()
    rows = mesh5_kernel_rows(fa)
    line = {"phase": "mesh5", "card": smi, "workers": MESH_WORKERS,
            "reduced": "depth only (gang A 16 -> 2, gang B 16 -> 2): four "
                       "ranks share one card and the host, and every "
                       "collective crosses gloo through host memory",
            "k1": rows, "gangs": {}}
    launches = {n: 0 for n in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
    # one job: the same 4 ranks run gang A, then gang B
    jobs, line["job_s"] = mesh_job("mesh5", "--mesh5-worker", {"gangs": {
        gang: {"mesh": g["mesh"], "model": dataclasses.asdict(
            mesh5_config(gang)), "B": g["B"], "T": g["T"],
            "check_B": g["check_B"], "check_T": g["check_T"],
            "steps": MESH5_STEPS, "overlaps": g["overlaps"],
            "checkpoint": g["checkpoint"]}
        for gang, g in MESH5_GANGS.items()}}, MESH5_TIMEOUT_S)
    for gang in ("A", "B"):
        g = MESH5_GANGS[gang]
        cfg = mesh5_config(gang)
        docs = [job[gang] for job in jobs]
        check(len({d["backend"] for d in docs}) == 1,
              f"mesh5 {gang}: backends differ")
        runs = {}
        for overlap in map(str, g["overlaps"]):
            losses = [d["train"][overlap]["losses"] for d in docs]
            check(all(ls == losses[0] for ls in losses),
                  f"mesh5 {gang} {overlap}: ranks disagree {losses}")
            check(all(math.isfinite(x) for x in losses[0])
                  and losses[0][-1] < losses[0][0],
                  f"mesh5 {gang} {overlap}: losses {losses[0]}")
            per_step = [{n: c / MESH5_STEPS for n, c in
                         d["train"][overlap]["launches"].items()}
                        for d in docs]
            # every rank runs its stage on each of the M + P - 1 steps:
            # (M + P - 1) x L/P launches of each of K1-K3 a step
            want = ((cfg.microbatches + g["mesh"]["pp"] - 1)
                    * cfg.n_layers // g["mesh"]["pp"])
            check(all(c == {n: want for n in c} for c in per_step),
                  f"mesh5 {gang} {overlap}: launches {per_step} != {want}")
            for d in docs:
                for n, c in d["train"][overlap]["launches"].items():
                    launches[n] += c
            runs[overlap] = {
                "losses": losses[0],
                **{k: [d["train"][overlap][k] for d in docs]
                   for k in ("step_p50_ms", "step_ms", "peak_gb",
                             "staged_bytes_per_step",
                             "all_reduce_bytes_per_step",
                             "buckets_per_step", "exposed_s_per_step")},
                "launches_per_step_per_rank": per_step[0]}
        if "device" in runs:
            a, b = runs["None"]["losses"], runs["device"]["losses"]
            rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
            check(rel <= MESH5_OVERLAP_RTOL,
                  f"mesh5 {gang}: overlap='device' losses {b} vs {a}")
            runs["device"]["loss_rel_diff_vs_fused"] = rel
            runs["device"]["bit_equal_to_fused"] = a == b
            equal = [d["train"]["device"]["leaves_equal_to_fused"]
                     for d in docs]
            check(all(equal), f"mesh5 {gang}: overlap='device' leaves "
                              f"differ from the fused run's: {equal}")
            runs["device"]["leaves_equal_to_fused"] = equal
        # the replicas of every leaf agree, in each overlap mode
        for overlap in map(str, g["overlaps"]):
            for name in docs[0]["sha256"]:
                held = {}
                for d in docs:
                    key, sha = d["train"][overlap]["sha256"][name]
                    held.setdefault(tuple(key), set()).add(sha)
                check(all(len(v) == 1 for v in held.values()),
                      f"mesh5 {gang} {overlap}: {name} differs between "
                      "ranks that hold it")
        doc = {"mesh": g["mesh"], "model": "flagship_moe_8x2" if cfg.routed
               else "flagship", "n_layers": cfg.n_layers,
               "microbatches": cfg.microbatches, "B": g["B"], "T": g["T"],
               "backend": docs[0]["backend"],
               "coords": [d["coords"] for d in docs],
               "groups": docs[0]["groups"],
               "params_local": [d["params_local"] for d in docs],
               "f32_check": [d["f32"] for d in docs], "runs": runs,
               "wall_s": [d["wall_s"] for d in docs]}
        if g["checkpoint"]:
            ck = [d["checkpoint"] for d in docs]
            check(all(c["restored_equal"] and c["step_sha_equal"]
                      and c["step_losses"][0] == c["step_losses"][1]
                      for c in ck), f"mesh5 {gang}: checkpoint {ck}")
            doc["checkpoint"] = {k: [c[k] for c in ck] for k in ck[0]}
        if cfg.routed:
            fr = [d["overflow_fraction"] for d in docs]
            # the ranks of one ep coordinate route the same choices
            by_ep = {}
            for d in docs:
                by_ep.setdefault(d["coords"]["ep"], set()).add(
                    d["overflow_fraction"])
            check(all(len(v) == 1 for v in by_ep.values()),
                  f"mesh5 {gang}: overflow fractions {fr}")
            doc["overflow_fraction"] = fr
        line["gangs"][gang] = doc
    line["wall_s"] = time.time() - t_start
    return line, rows, launches


# ---------------------------------------------------------------------------
# phase 7f: sharded serving — the flagship's engine on a dp x tp mesh
# ---------------------------------------------------------------------------

SHARD_MESH = {"dp": 2, "tp": 2}
SHARD_H = 8   # the flagship's 16 heads over tp=2
SHARD_TIMEOUT_S = 300
SHARD_F32_LAYERS = 2
SHARD_LAYERS = 8     # the served flagship's depth (16: the smoke's time)
SHARD_LOGIT_TOL = 1e-4   # the gather phase's: f32, summation order only
#: the phase's model and requests: the flagship with the slice phase's
#: prompts on the card; ``tests/test_torch_shard_serve.py`` runs it with
#: the serving entry's tiny model on the CPU
SHARD_RUN = dict(model="flagship", device="cuda", dir=None, log_dir=None,
                 prompt_lens=[int(x) for x in np.linspace(17, 511, 8)],
                 max_tokens=32, n_blocks=256)
SHARD_RUNS = (("gather", "auto", 0), ("gather_spec", "auto", 3),
              ("paged", "on", 0))
SHARD_F32_RUNS = (("gather", "off", 0), ("gather_spec", "off", 3),
                  ("paged", "on", 0))
SHARD_OPS = ("all_reduce", "all_gather", "broadcast")
SHARD_KERNELS = ("flash_fwd", "paged_attention")


def shard_kernel_rows(fa, pa, prompt_lens):
    """K1 and K4 at the shapes a tp=2 rank of the flagship gives them (8
    of its 16 heads), against their plain versions, beside SDPA
    (yardstick only): K1 at B=1, T=512, causal, bf16; K4 at B=8, S in
    {1, 4}, bf16 pools, block 16, on the paged phase's engine lengths.
    Returns ``(K1's row, K4's rows)``."""
    gen = torch.Generator("cuda").manual_seed(5)
    b, t, h, d = 1, 512, SHARD_H, 128
    q, k, v = (torch.randn((b, t, h, d), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    mx, mean = fwd_check(fa, q, k, v, fa.flash_attention(q, k, v,
                                                         causal=True))
    k1 = fwd_timing(fa, q, k, v, b, t, h, d, phase="shard_flash")
    k1.update(max_abs_err=mx, mean_abs_err=mean)
    w = math.ceil((max(prompt_lens) + 32 + 3) / 16)
    k4 = [paged_case(pa, gen, dtype=torch.bfloat16, s_w=s_w, w=w, h=h,
                     lengths=[n + 16 for n in prompt_lens],
                     phase="shard_paged") for s_w in (1, 4)]
    return k1, k4


def shard_model_config(name):
    """The phase's model: the flagship's widths at depth SHARD_LAYERS, or
    ``serving.serve``'s tiny one."""
    from dmlc_tpu_torch.models import transformer as tfm
    from dmlc_tpu_torch.serving import serve

    if name != "flagship":
        return serve.TINY
    return dataclasses.replace(tfm.flagship_config(), n_layers=SHARD_LAYERS)


def _counters(tele, ops=SHARD_OPS):
    """This rank's collective calls and bytes by op, and (as ``staged``)
    the bytes the port copies through pinned host memory itself."""
    out = {op: [tele.core.counter_value("collective", f"{op}_calls"),
                tele.core.counter_value("collective", f"{op}_bytes")]
           for op in ops}
    out["staged"] = [0.0, tele.core.counter_value(
        "collective", "ppermute_staged_bytes")]
    return out


def _delta(after, before, n=1):
    return {op: {"calls": (after[op][0] - before[op][0]) / n,
                 "bytes": (after[op][1] - before[op][1]) / n}
            for op in after}


class ServeRank:
    """One rank's side of a sharded-serving job on ``mesh``: the
    engine's runs (:meth:`serve`) and one counted prefill and decode
    step of each path (:meth:`steps`), with the collectives ``ops``
    counted on this rank and K1/K4 counted from 0 before each run."""

    def __init__(self, conf, mesh, vocab, ops=SHARD_OPS):
        from dmlc_tpu_torch import serving
        from dmlc_tpu_torch import telemetry as tele
        from dmlc_tpu_torch.ops import flash_attention as fa
        from dmlc_tpu_torch.ops import paged_attention as pa

        self.serving, self.tele = serving, tele
        self.conf, self.mesh, self.ops = conf, mesh, ops
        self.rank, self.dev = mesh.rank, mesh.device
        self.card = conf["device"] == "cuda"
        self.kernels = {"flash_fwd": fa.FLASH_FWD,
                        "paged_attention": pa.PAGED_ATTENTION}
        self.prompts, self.looping = slice_prompts(vocab,
                                                   conf["prompt_lens"])

    def sync(self):
        if self.card:
            torch.cuda.synchronize()

    def launches(self):
        return {n: k.launches for n, k in self.kernels.items()}

    def serve(self, m, mode, spec_k, on_mesh=True, batch=None,
              direct=False):
        """One engine over ``m`` (on the mesh, else rank 0's one card)
        under ``DMLC_SERVE_PAGED_ATTN=mode``, ``batch`` (default: the
        prompts, the looping ones at spec_k > 0) POSTed to rank 0's HTTP
        server; K1/K4 counted from 0 just before.  ``direct`` submits
        every request before the engine starts instead, so that the
        decode batches do not hang on the clients' timing: a routed
        model's tokens depend on which rows share a call (they compete
        for expert capacity), and two engines held to equal tokens must
        batch alike.  Returns the outputs only then."""
        tele, conf = self.tele, self.conf
        os.environ["DMLC_SERVE_PAGED_ATTN"] = mode
        tele.reset()
        tele.reset_steps()
        for kern in self.kernels.values():
            kern.launches = 0
        eng = self.serving.InferenceEngine(
            m, mesh=self.mesh if on_mesh else None, device=self.dev,
            n_blocks=conf["n_blocks"], block_size=16, max_active=8,
            queue_depth=64, spec_k=spec_k)
        if self.rank:
            eng.follow()
            return {"launches": self.launches()}
        if batch is None:
            batch = self.looping if spec_k else self.prompts
        if direct:
            reqs = [eng.submit(p, max_new_tokens=conf["max_tokens"])
                    for p in batch]
            eng.start()
            try:
                for r in reqs:
                    check(r.wait(600) and r.error is None,
                          f"request {r.id}: {r.error}")
            finally:
                eng.close()
            return {"requests": len(reqs), "launches": self.launches(),
                    "outputs": [list(r.generated) for r in reqs]}
        eng.start()
        srv = self.serving.ServingHTTPServer(eng)
        try:
            before = _counters(tele, self.ops)
            results, wall, first = post_prompts(srv.url, batch,
                                                conf["max_tokens"])
            after = _counters(tele, self.ops)
            recs = tele.ledger().records()
            reqs = eng.requests.summary()
            cost = eng._decode.stats() if hasattr(eng._decode, "stats") \
                else None
        finally:
            srv.close()
            eng.close()
        ttft = sorted(d["ttft_s"] for _, d in results)
        tokens = sum(d["n_generated"] for _, d in results)
        c = eng.counters
        last = (cost or {}).get("last_cost") or {}
        return {"mode": mode, "spec_k": spec_k, "paged": eng._use_paged,
                "requests": len(results),
                "requests_200": sum(code == 200 for code, _ in results),
                "wall_s": wall, "first_served_unix": first,
                "tokens": tokens, "tokens_per_s": tokens / wall,
                "ttft_p50_s": pctl(ttft, 50), "ttft_p99_s": pctl(ttft, 99),
                "step_p50_s": pctl([r["wall_s"] for r in recs], 50),
                "gap_p99_s": reqs["tbt_p99_s"],
                "prefills": c["prefills"], "decode_steps": c["decode_steps"],
                "preemptions": c["preemptions"],
                "launches": self.launches(),
                "collectives_per_decode_step": _delta(
                    after, before, max(c["decode_steps"], 1)),
                "counted_flops": last.get("flops"),
                "counted_over_global_flops": (
                    last["flops"] / recs[-1]["flops"]
                    if last.get("flops") and recs else None),
                "outputs": [d["output_ids"] for _, d in results]}

    def steps(self, tfm, m, inp):
        """``{name: (logits, ms, collectives)}`` of a sharded prefill of
        ``inp`` and a decode step of ``m`` on each path (every rank calls
        it): the gather view of this rank's dp rows, its heads of its
        stage's layers."""
        import torch.distributed as dist

        mesh = self.mesh
        shard = {"axes": tfm.serving_axes(mesh), "mesh": mesh}
        dp, di = mesh.axis_size("dp"), mesh.axis_rank("dp")
        out = {}

        def counted(name, fn):
            dist.barrier()
            self.sync()
            before, ts = _counters(self.tele, self.ops), time.perf_counter()
            with torch.inference_mode():
                got = fn()
            self.sync()
            out[name] = (got, (time.perf_counter() - ts) * 1e3,
                         _delta(_counters(self.tele, self.ops), before))
            return got

        _, k, v = counted("prefill", lambda: prefill(tfm, m, inp, **shard))
        kp, vp = decode_pools(k, v, inp)
        b, w = inp["tables"].shape
        kd, vd = (x[:, inp["tables"].long()].reshape(
            x.shape[0], b, w * 16, *x.shape[3:]).chunk(dp, dim=1)[di]
            for x in (kp, vp))
        lens = inp["lengths"]
        counted("gather", lambda: tfm.forward_decode(
            m, inp["dids"][:, 0], lens.long(), kd, vd, lens, **shard)[0])
        counted("paged", lambda: decode(tfm, m, inp, kp, vp, **shard)[:, 0])
        out["prefill"] = (out["prefill"][0][0],) + out["prefill"][1:]
        return out


def f32_against_one_card(tfm, sr, got, want, sharded, one, runs, phase):
    """Rank 0's f32 gates: each run's tokens (``got``) equal to one
    card's (``want`` by spec_k), and the sharded prefill and decode
    logits (``sharded``, :meth:`ServeRank.steps`) within
    ``SHARD_LOGIT_TOL`` of one card's model ``one``.  Returns the
    numbers."""
    f32 = {"n_layers": SHARD_F32_LAYERS, "tokens_equal": all(
        got[name]["outputs"] == want[k] for name, _, k in runs)}
    check(f32["tokens_equal"], f"{phase}: f32 tokens differ from one "
          "card's: " + json.dumps({name: _agreement(
              got[name]["outputs"], want[k]) for name, _, k in runs}))
    inp = slice_inputs(one.cfg, sr.dev)
    lp, k, v = prefill(tfm, one, inp)
    kp, vp = decode_pools(k, v, inp)
    ref = decode(tfm, one, inp, kp, vp)[:, 0]

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()

    f32["prefill_logits_rel"] = rel(sharded["prefill"][0], lp)
    f32["decode_logits_rel"] = {n: rel(sharded[n][0], ref)
                                for n in ("gather", "paged")}
    check(f32["prefill_logits_rel"] <= SHARD_LOGIT_TOL
          and max(f32["decode_logits_rel"].values()) <= SHARD_LOGIT_TOL,
          f"{phase}: f32 logits against one card {f32}")
    f32["requests"] = sum(r["requests"] for r in got.values())
    return f32


def shard_serve_worker(argv) -> int:
    """One rank of the shard_serve phase (under the port's launcher):
    ``initialize_distributed()``, ``build_mesh(dp=2, tp=2)``, the
    flagship's shards of the seed-0 weights; the engine on the mesh for
    each run of ``SHARD_RUNS`` (rank 0 serves it over HTTP, the others
    follow), one sharded prefill and decode step counted, then the f32
    depth-2 copy against one card; then the gangs of
    ``conf["wide"]`` (:func:`wide_gangs`, the shard_serve_wide phase's).
    Writes ``<out>/shard_serve.<rank>.json``."""
    sys.path.insert(0, ROOT)
    from dmlc_tpu_torch.models import transformer as tfm
    from dmlc_tpu_torch.models.convert import (gather_params,
                                               shard_params_from_jax)
    from dmlc_tpu_torch.parallel import build_mesh, initialize_distributed
    from dmlc_tpu_torch.tracker.client import TrackerClient
    import torch.distributed as dist

    out_dir = argv[0]
    with open(os.path.join(out_dir, "config.json")) as f:
        conf = json.load(f)
    card = conf["device"] == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    client = TrackerClient()
    client.start()
    t0 = time.perf_counter()
    backend = initialize_distributed(timeout_s=SHARD_TIMEOUT_S)
    mesh = build_mesh(pp=1, sp=1, ep=1, **conf["mesh"],
                      device=None if card else "cpu")
    rank, dev = mesh.rank, mesh.device

    # the slice phase's global weights (seed 0), this rank's shards
    cfg = shard_model_config(conf["model"])
    glob = tfm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    tree = gather_params(glob)
    del glob
    model = shard_params_from_jax(tree, cfg, mesh)
    tree2 = {**{k: tree[k] for k in ("embed", "unembed", "ln_f")},
             "blocks": {k: x[:, :SHARD_F32_LAYERS].clone()
                        for k, x in tree["blocks"].items()}}
    del tree
    if card:
        torch.cuda.empty_cache()
    doc = {"rank": rank, "coords": mesh.coords, "backend": backend,
           "device": str(dev), "init_s": time.perf_counter() - t0,
           "params_local": sum(p.numel() for p in model.parameters())}
    sr = ServeRank(conf, mesh, cfg.vocab)

    # 1. the flagship, bf16, served depth: one short request to warm up (as
    # the slice phase's), then three runs on the mesh
    doc["warmup"] = sr.serve(model, "auto", 0, batch=[sr.prompts[0][:17]])
    doc["runs"] = {name: sr.serve(model, mode, k)
                   for name, mode, k in SHARD_RUNS}

    # 2. one sharded prefill and decode step (B=8, contexts 17..511), the
    # collectives each makes counted on this rank
    doc["decode_step"] = {name: {"ms": ms, "collectives": coll}
                          for name, (_, ms, coll) in sr.steps(
                              tfm, model, slice_inputs(cfg, dev)).items()}
    del model
    if card:
        torch.cuda.empty_cache()

    # 3. the float32 copy at depth 2: tokens and logits against one card
    cfg2 = dataclasses.replace(cfg, dtype="float32",
                               n_layers=SHARD_F32_LAYERS)
    m2 = shard_params_from_jax(tree2, cfg2, mesh)
    one = None
    if rank == 0:
        one = shard_params_from_jax(tree2, cfg2, None, device=dev)
        want = {k: sr.serve(one, "auto", k, on_mesh=False,
                            direct=True)["outputs"] for k in (0, 3)}
    got = {name: sr.serve(m2, mode, k, direct=True)
           for name, mode, k in SHARD_F32_RUNS}
    sharded = sr.steps(tfm, m2, slice_inputs(cfg2, dev))
    if rank == 0:
        doc["f32"] = f32_against_one_card(tfm, sr, got, want, sharded, one,
                                          SHARD_F32_RUNS, "shard_serve")
    doc["f32_launches"] = {name: r["launches"] for name, r in got.items()}
    doc["wall_s"] = time.perf_counter() - t0
    del m2, one
    if conf.get("wide"):
        # shard_serve_wide's gangs, on the same ranks
        doc["wide"] = wide_gangs(tfm, conf)
    with open(os.path.join(out_dir, f"shard_serve.{rank}.json"), "w") as f:
        json.dump(doc, f)
    client.log(f"rank {rank}: shard_serve phase done")
    dist.destroy_process_group()
    client.shutdown()
    return 0


def shard_serve_phase(smi, one_card, run=None, wide=False):
    """Sharded serving (see the module docstring): 4 workers of the
    port's launcher sharing the card, each ``chip_smoke.py
    --shard-serve-worker``, the flagship's engine on dp2 x tp2 behind
    rank 0's HTTP server.  ``one_card`` has the slice and gather phases'
    runs (numbers and bf16 token streams) to set beside these, or None.
    Gates: every rank's K1 launches ``n_layers`` a prefill on each run,
    K4 none on the gather runs and ``n_layers`` a decode step on the
    paged one (0 of both on the CPU, where the plain versions run);
    every request 200 and every rank exited 0 (``_submit``); the f32
    depth-2 tokens and logits, in the workers.  With ``wide`` the same
    workers then serve ``shard_serve_wide``'s gangs (one spawn for
    both).  Returns the phase's line, the K1/K4 launches summed over the
    ranks' bf16 runs, and (``wide``) each rank's gang documents for
    :func:`shard_serve_wide_phase`."""
    run = {**SHARD_RUN, **(run or {})}
    card = run["device"] == "cuda"
    t_start = time.time()
    cfg = shard_model_config(run["model"])
    conf = {"mesh": SHARD_MESH, "model": run["model"],
            "device": run["device"], "prompt_lens": run["prompt_lens"],
            "max_tokens": run["max_tokens"], "n_blocks": run["n_blocks"],
            "wide": list(WIDE_GANGS) if wide else []}
    env = dict(MESH_ENV) if card else {"OMP_NUM_THREADS": "1"}
    docs, job_s = mesh_job("shard_serve", "--shard-serve-worker", conf,
                           SHARD_TIMEOUT_S, root=run["dir"],
                           log_dir=run["log_dir"], env=env)
    ctl = docs[0]
    launches = {n: 0 for n in SHARD_KERNELS}
    for name, _, _ in SHARD_RUNS:
        r = ctl["runs"][name]
        want = {"flash_fwd": cfg.n_layers * r["prefills"],
                "paged_attention": (cfg.n_layers * r["decode_steps"]
                                    if r["paged"] else 0)}
        if not card:   # the CPU runs the plain versions
            want = {n: 0 for n in want}
        for d in docs:
            got = d["runs"][name]["launches"]
            check(got == want, f"shard_serve {name}: rank {d['rank']} "
                  f"launches {got}, want {want}")
            for n in launches:
                launches[n] += got[n]
        check(r["requests_200"] == r["requests"],
              f"shard_serve {name}: {r['requests_200']}/{r['requests']}")
    runs = {name: {k: v for k, v in ctl["runs"][name].items()
                   if k not in ("outputs", "first_served_unix")}
            for name, _, _ in SHARD_RUNS}
    line = {
        "phase": "shard_serve", "card": smi, "model": run["model"],
        "mesh": SHARD_MESH, "workers": MESH_WORKERS,
        "backend": ctl["backend"], "n_layers": cfg.n_layers,
        "heads_per_rank": cfg.n_heads // SHARD_MESH["tp"],
        "params_local": [d["params_local"] for d in docs],
        "init_s": [d["init_s"] for d in docs], "runs": runs,
        "decode_step_rank0": ctl["decode_step"],
        "f32": ctl["f32"], "ranks_done": len(docs),
        "spawn_to_first_served_s": (ctl["warmup"]["first_served_unix"]
                                    - t_start),
        "job_s": job_s, "wall_s": time.time() - t_start}
    if one_card is not None:
        line["one_card"] = {name: {k: one_card["docs"][name][k] for k in (
            "tokens_per_s", "ttft_p50_s", "ttft_p99_s", "step_p50_s",
            "gap_p99_s")} for name in one_card["docs"]}
        if one_card.get("n_layers") == cfg.n_layers:   # the same model
            line["bf16_vs_one_card"] = {
                name: _agreement(ctl["runs"][name]["outputs"],
                                 one_card["outputs"][1 if k else 0])
                for name, _, k in SHARD_RUNS}
    if wide:
        return line, launches, [{**d.pop("wide"), "rank": d["rank"]}
                                for d in docs]
    return line, launches


# ---------------------------------------------------------------------------
# phase 7g: sharded serving on the rest of the mesh — a routed flagship on
# dp2 x ep2 and a pipelined flagship on pp2 x tp2
# ---------------------------------------------------------------------------

#: the phase's two gangs, served in turn by the same 4 workers: R the
#: routed flagship (top-2 of 8) on dp2 x ep2, 4 experts a rank; P the
#: dense flagship on pp2 x tp2, half the layers and 8 heads a rank
WIDE_GANGS = {"R": {"mesh": {"pp": 1, "dp": 2, "sp": 1, "ep": 2, "tp": 1},
                    "routed": True},
              "P": {"mesh": {"pp": 2, "dp": 1, "sp": 1, "ep": 1, "tp": 2},
                    "routed": False}}
#: the bf16 runs and the f32 depth-2 copy's: ``auto`` (the gather path on
#: both gangs' meshes, as the reference's ``auto`` picks) and ``on``
WIDE_RUNS = (("gather", "auto", 0), ("paged", "on", 0))
WIDE_OPS = ("all_reduce", "all_gather", "broadcast", "ppermute")


def wide_config(name, gang):
    """Gang ``gang``'s model: the flagship (or the serving entry's tiny
    model), routed top-2 of 8 for gang R."""
    cfg = shard_model_config(name)
    return moe_config(cfg) if WIDE_GANGS[gang]["routed"] else cfg


@torch.no_grad()
def seeded_model(tfm, cfg, mesh, device, seed=0):
    """``cfg``'s model on ``mesh`` (None: whole) with weights drawn leaf
    by leaf from ``seed``: norms at 1, each other leaf ``N(0, 0.02)``
    from a generator of its own (its name, and its global layer for a
    block leaf), drawn whole in float32 and cut to this rank's shard.  A
    layer's weights depend neither on the depth nor on the mesh, so a
    depth-2 copy on one card holds a mesh model's first two layers, and
    a rank holds no more than its shards and one leaf of one layer."""
    model = tfm.Transformer(cfg, device=device, mesh=mesh)
    first = 0 if mesh is None else mesh.axis_rank("pp") * len(model.layers)
    leaves = sorted(tfm.PARAM_SPECS)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("ln1", "ln2", "ln_f"):
            p.fill_(1.0)
            continue
        layer = first + int(name.split(".")[1]) if "." in name else 0
        specs = tfm.PARAM_SPECS[leaf] if mesh is not None else ()
        shape = list(p.shape)
        for dim, axis in specs:
            shape[dim] *= mesh.axis_size(axis)
        gen = torch.Generator(device).manual_seed(
            seed * 1_000_003 + leaves.index(leaf) * 1009 + layer)
        t = torch.randn(shape, generator=gen, device=device) * 0.02
        for dim, axis in specs:
            t = t.chunk(mesh.axis_size(axis), dim=dim)[mesh.axis_rank(axis)]
        p.copy_(t)
    return model


class _Drops:
    """Every routed call's ``(dropped, local)`` choice counts on this
    rank while ``moe_debug_overflow`` is on: ``tfm._record_moe_overflow``
    wrapped, each call's counts kept beside the ``moe`` stage's
    fraction.  ``take()`` returns and clears them."""

    def __init__(self, tfm):
        self.calls = []
        real = tfm._record_moe_overflow

        def record(keep, local):
            self.calls.append((float(local.sum() - keep.sum()),
                               float(local.sum())))
            real(keep, local)

        tfm._record_moe_overflow = record

    def take(self):
        calls, self.calls = self.calls, []
        return torch.tensor(calls or [[0.0, 0.0]], dtype=torch.float64)


def wide_gang(tfm, gang, mesh, conf):
    """Gang ``gang`` on ``mesh`` (every worker calls it): the bf16 model
    at the served depth, a warm-up request and ``WIDE_RUNS`` served, a counted
    prefill and decode step; then the f32 depth-2 copy's runs against
    one card on rank 0, for gang R with each run's dropped-choice
    fraction summed over ep.  Returns this rank's document."""
    from dmlc_tpu_torch.parallel.collectives import all_reduce

    t0 = time.perf_counter()
    rank, dev = mesh.rank, mesh.device
    cfg = wide_config(conf["model"], gang)
    model = seeded_model(tfm, cfg, mesh, dev)
    sr = ServeRank(conf, mesh, cfg.vocab, WIDE_OPS)
    sr.sync()
    doc = {"rank": rank, "coords": mesh.coords,
           "layers_local": len(model.layers),
           "params_local": sum(p.numel() for p in model.parameters()),
           "init_s": time.perf_counter() - t0}
    doc["warmup"] = sr.serve(model, "auto", 0, batch=[sr.prompts[0][:17]])
    doc["runs"] = {name: sr.serve(model, mode, k)
                   for name, mode, k in WIDE_RUNS}
    doc["decode_step"] = {name: {"ms": ms, "collectives": coll}
                          for name, (_, ms, coll) in sr.steps(
                              tfm, model, slice_inputs(cfg, dev)).items()}
    del model
    gc.collect()
    if sr.card:
        torch.cuda.empty_cache()

    cfg2 = dataclasses.replace(cfg, dtype="float32",
                               n_layers=SHARD_F32_LAYERS,
                               moe_debug_overflow=cfg.routed)
    drops = _Drops(tfm)
    m2 = seeded_model(tfm, cfg2, mesh, dev)
    one = None
    if rank == 0:
        one = seeded_model(tfm, cfg2, None, dev)
        want = {0: sr.serve(one, "auto", 0, on_mesh=False,
                            direct=True)["outputs"]}
        one_drops = drops.take()
    got, fracs = {}, {}
    for name, mode, k in WIDE_RUNS:
        got[name] = sr.serve(m2, mode, k, direct=True)
        # each rank counts its own experts' choices; their sum over ep is
        # one program's count
        summed = all_reduce(drops.take().to(dev), "ep", mesh=mesh).sum(0)
        fracs[name] = (summed[0] / summed[1].clamp_min(1)).item()
    sharded = sr.steps(tfm, m2, slice_inputs(cfg2, dev))
    drops.take()
    if rank == 0:
        f32 = f32_against_one_card(tfm, sr, got, want, sharded, one,
                                   WIDE_RUNS, f"shard_serve_wide {gang}")
        if cfg.routed:
            tot = one_drops.sum(0)
            f32["dropped_fraction"] = {"one_card": (tot[0] / tot[1]).item(),
                                       **fracs}
            # the paged run routes the live rows as one card's engine
            # does; the gather run also routes the dead rows it pads with
            check(fracs["paged"] == f32["dropped_fraction"]["one_card"],
                  f"shard_serve_wide {gang}: dropped-choice fraction "
                  f"{f32['dropped_fraction']}")
        doc["f32"] = f32
    doc["f32_launches"] = {name: r["launches"] for name, r in got.items()}
    doc["wall_s"] = time.perf_counter() - t0
    return doc


def wide_gangs(tfm, conf):
    """Each gang of ``conf["wide"]`` on its own ``build_mesh`` over this
    process group's 4 ranks (:func:`wide_gang`), after the shard_serve
    worker's own: ``{"gangs": {gang: this rank's document}}``."""
    from dmlc_tpu_torch.parallel import build_mesh

    card = conf["device"] == "cuda"
    out = {"gangs": {}}
    for gang in conf["wide"]:
        mesh = build_mesh(**WIDE_GANGS[gang]["mesh"],
                          device=None if card else "cpu")
        out["gangs"][gang] = wide_gang(tfm, gang, mesh, conf)
        # a closed engine's pools live until the collector breaks its
        # server's handler-class cycle
        gc.collect()
        if card:
            torch.cuda.empty_cache()
    return out


def shard_serve_wide_phase(smi, beside, docs, run=None):
    """Sharded serving on the rest of the mesh (see the module
    docstring): the 4 workers of ``shard_serve``'s job, after their own
    gang, serve gang R (the routed flagship on dp2 x ep2) and then gang
    P (the dense flagship on pp2 x tp2) behind rank 0's HTTP server;
    ``docs`` are the ranks' documents of them (:func:`shard_serve_phase`
    with ``wide``), ``run`` the same as that phase's.  ``beside`` has
    the numbers of one card's runs and of ``shard_serve`` to set beside
    these, or None.
    Gates: on every rank and run, K1 its local layers a prefill, K4 its
    local layers a decode step on the paged run and none on the gather
    run (0 of both on the CPU, where the plain versions run); every
    request 200 and every rank exited 0 (``_submit``); the f32 depth-2
    tokens, logits and (gang R) dropped-choice fraction, in the workers.
    Returns the phase's line and the K1/K4 launches summed over the
    ranks' bf16 runs of both gangs."""
    run = {**SHARD_RUN, **(run or {})}
    card = run["device"] == "cuda"
    line = {"phase": "shard_serve_wide", "card": smi, "model": run["model"],
            "workers": MESH_WORKERS, "job": "shard_serve's, after its gang",
            "ranks_done": len(docs), "gangs": {}}
    launches = {n: 0 for n in SHARD_KERNELS}
    for gang, spec in WIDE_GANGS.items():
        cfg = wide_config(run["model"], gang)
        ranks = [d["gangs"][gang] for d in docs]
        ctl = ranks[0]
        for name, _, _ in WIDE_RUNS:
            r = ctl["runs"][name]
            for d in ranks:
                n_l = d["layers_local"]
                want = {"flash_fwd": n_l * r["prefills"],
                        "paged_attention": (n_l * r["decode_steps"]
                                            if r["paged"] else 0)}
                if not card:   # the CPU runs the plain versions
                    want = {n: 0 for n in want}
                got = d["runs"][name]["launches"]
                check(got == want, f"shard_serve_wide {gang} {name}: rank "
                      f"{d['rank']} launches {got}, want {want}")
                for n in launches:
                    launches[n] += got[n]
            check(r["requests_200"] == r["requests"],
                  f"shard_serve_wide {gang} {name}: "
                  f"{r['requests_200']}/{r['requests']}")
        line["gangs"][gang] = {
            "mesh": {a: n for a, n in spec["mesh"].items() if n > 1},
            "routed": cfg.routed, "n_layers": cfg.n_layers,
            "layers_per_rank": ctl["layers_local"],
            "heads_per_rank": cfg.n_heads // spec["mesh"]["tp"],
            "experts_per_rank": cfg.n_experts // spec["mesh"]["ep"],
            "params_local": [d["params_local"] for d in ranks],
            "init_s": [d["init_s"] for d in ranks],
            "runs": {name: {k: v for k, v in ctl["runs"][name].items()
                            if k not in ("outputs", "first_served_unix")}
                     for name, _, _ in WIDE_RUNS},
            "launches_per_rank": {name: [d["runs"][name]["launches"]
                                         for d in ranks]
                                  for name, _, _ in WIDE_RUNS},
            "decode_step_rank0": ctl["decode_step"], "f32": ctl["f32"],
            "wall_s": ctl["wall_s"]}
    if beside is not None:
        line["beside"] = beside
    line["wall_s"] = sum(g["wall_s"] for g in line["gangs"].values())
    return line, launches


# ---------------------------------------------------------------------------
# phase 8c: the fleet router over two flagship replicas sharing the card

ROUTER_LOAD = dict(n_streams=8, requests_per_stream=2, prompt_len=(17, 511),
                   max_tokens=32, seed=0)
ROUTER_HEALTH_S, ROUTER_PROBE_MAX_S = 0.25, 2.0
#: the replicas: the flagship's widths at depth 2 (full depth before the
#: ``remote`` phase came; the phase's gates do not depend on depth)
ROUTER_MODEL = ("--model", "flagship", "--layers", "2")


class _FleetProc:
    """One process of the fleet (a replica or the router) in a session of
    its own, its output in ``chiprun_out/router_<name>.log``; ``url`` is
    read from the line it prints once it listens (``--port 0`` or a
    given port)."""

    def __init__(self, name, argv, env, log_dir=None):
        log_dir = log_dir or os.path.join(ROOT, "chiprun_out")
        os.makedirs(log_dir, exist_ok=True)
        self.name = name
        self.log_path = os.path.join(log_dir, f"router_{name}.log")
        self.log = open(self.log_path, "w")
        self.t_spawn = time.monotonic()
        self.p = subprocess.Popen([sys.executable, "-m", *argv], cwd=ROOT,
                                  env=env, stdout=self.log,
                                  stderr=subprocess.STDOUT,
                                  start_new_session=True)
        self.url = None
        self.t_listen = None

    def wait_url(self, word, timeout=300):
        deadline = time.monotonic() + timeout
        while self.url is None:
            with open(self.log_path) as f:
                m = re.search(rf"{word}.*?(http://[0-9.]+:[0-9]+)", f.read())
            if m:
                self.url, self.t_listen = m.group(1), time.monotonic()
                break
            check(self.p.poll() is None,
                  f"router phase: {self.name} exited {self.p.returncode} "
                  f"before it listened ({self.log_path})")
            check(time.monotonic() < deadline,
                  f"router phase: {self.name} never listened")
            time.sleep(0.05)
        return self.url

    @property
    def port(self):
        return int(self.url.rsplit(":", 1)[1])

    def kill(self):
        """Kill the process's whole session; True if anything was left."""
        try:
            os.killpg(self.p.pid, 0)
        except ProcessLookupError:
            left = False
        else:
            left = True
            os.killpg(self.p.pid, signal.SIGKILL)
        self.p.wait(timeout=60)
        self.log.close()
        return left


def _fleet_env():
    env = dict(os.environ)
    env.update({
        "PYTHONPATH": ROOT + os.pathsep + env.get("PYTHONPATH", ""),
        "OMP_NUM_THREADS": "2", "DMLC_TRACE_FLEET": "1",
        # the smoke's serving settings
        "DMLC_SERVE_KV_BLOCKS": "256", "DMLC_SERVE_KV_BLOCK_SIZE": "16",
        "DMLC_SERVE_MAX_ACTIVE": "8", "DMLC_SERVE_QUEUE_DEPTH": "64",
        # a kill and a restart show within a second or two
        "DMLC_ROUTER_HEALTH_INTERVAL_S": str(ROUTER_HEALTH_S),
        "DMLC_ROUTER_PROBE_BASE_S": str(ROUTER_HEALTH_S),
        "DMLC_ROUTER_PROBE_MAX_S": str(ROUTER_PROBE_MAX_S),
        "DMLC_ROUTER_PROBE_TIMEOUT_S": "2.0"})
    return env


def _replica(name, env, port=0, model=("--model", "flagship"), log_dir=None):
    return _FleetProc(name, ["dmlc_tpu_torch.serving.serve", *model,
                             "--seed", "0", "--port", str(port)],
                      env, log_dir)


def _replica_state(router_url, url):
    _, reps = http(router_url + "/replicas", timeout=30)
    return next(v for v in reps if v["url"] == url)


def _metric(text, name):
    m = re.search(rf"^{name} (\S+)$", text, re.M)
    return float(m.group(1)) if m else 0.0


def _launches(url, into=None):
    """A replica's K1/K4 launch counts from its /healthz (which must show
    the card); ``into`` also gets its active and waiting counts."""
    code, hz = http(url + "/healthz", timeout=30)
    check(code == 200 and str(hz["device"]).startswith("cuda"),
          f"router phase: replica {url} /healthz {code} on "
          f"{hz.get('device') if isinstance(hz, dict) else hz}")
    if into is not None:
        into.update(active=hz["active"], waiting=hz["waiting"])
    return dict(hz["kernel_launches"])


def _dispatches(router_url, trace_ids, names, t_ref):
    """Every ``router.dispatch`` of the given traces: (replica name, kind,
    outcome, status, start and end in s after the wall time ``t_ref``),
    in start order."""
    rows = []
    for tid in trace_ids:
        _, tl = http(router_url + f"/trace/{tid}")
        for e in tl["events"]:
            if e["name"] == "router.dispatch":
                a = e["args"]
                rows.append((names.get(a.get("replica"), a.get("replica")),
                             a.get("kind"), a.get("outcome"), a.get("status"),
                             e["t_wall"] - t_ref,
                             e["t_wall"] + e["dur_s"] - t_ref))
    return sorted(rows, key=lambda r: r[4])


def _load_run(serving, url, vocab, on_done=None):
    """The port's LoadGenerator (8 streams x 2 prompts of 17..511 tokens,
    32 new tokens, seed 0) at ``url``; each completion is stamped, and
    ``on_done(n)`` runs after the n-th.  Gates: every request answered
    200 at its first try."""
    stamps = []

    class Stamped(serving.LoadGenerator):
        def _post(self, doc, headers=None):
            out = super()._post(doc, headers)
            with self._lock:
                stamps.append((time.monotonic(), out.get("trace_id"),
                               out.get("served_by")))
                n = len(stamps)
            if on_done is not None:
                on_done(n)
            return out

    gen = Stamped(url, vocab=vocab, **ROUTER_LOAD)
    load = gen.run()
    n = ROUTER_LOAD["n_streams"] * ROUTER_LOAD["requests_per_stream"]
    check(load["n_requests_ok"] == n and not gen.failures
          and load["n_rejections_429"] == 0 and load["n_backoffs_503"] == 0,
          f"router phase: load at {url}: {load} {gen.failures[:2]}")
    return load, gen, stamps


def _load_numbers(load):
    return {k: load[k] for k in (
        "wall_s", "total_generated_tokens", "aggregate_tokens_per_s",
        "p50_ttft_s", "p99_ttft_s", "p50_latency_s", "e2e_latency_p50_s",
        "e2e_latency_p99_s", "client_server_delta_p50_s",
        "client_server_delta_p99_s", "tokens_per_s_per_user")}


def router_phase(smi, serving, vocab):
    """Two flagship replicas share the card behind the port's router:
    the load straight at one, then through the router, then with a
    replica SIGKILLed, restarted and a replica drained (see the module
    docstring for the gates)."""
    from dmlc_tpu_torch.telemetry.exporters import validate_exposition_text

    t_phase = time.perf_counter()
    shm0 = _dmlc_shm()
    env = _fleet_env()
    procs = {}
    line = {"phase": "router", "card": smi, "load": dict(ROUTER_LOAD),
            "replica_args": list(ROUTER_MODEL)}
    try:
        procs["A"], procs["B"] = (_replica("A", env, model=ROUTER_MODEL),
                                  _replica("B", env, model=ROUTER_MODEL))
        A, B = procs["A"].wait_url("serve:"), procs["B"].wait_url("serve:")
        line["replica_start_s"] = {n: procs[n].t_listen - procs[n].t_spawn
                                   for n in ("A", "B")}
        # one request each, so the first cost passes land before the runs
        for url in (A, B):
            code, doc = http(url + "/generate", {"prompt": list(range(1, 18)),
                                                 "max_tokens": 8})
            check(code == 200, f"router phase: warm-up at {url}: {doc}")
        base = {"A": _launches(A), "B": _launches(B)}
        procs["R"] = _FleetProc(
            "router", ["dmlc_tpu_torch.serving.route", "--replicas",
                       f"{A},{B}", "--port", "0"], env)
        R = procs["R"].wait_url("dmlc-router:", timeout=120)
        deadline = time.monotonic() + 60
        while http(R + "/healthz")[1]["healthy"] != 2:
            check(time.monotonic() < deadline, "router: replicas not healthy")
            time.sleep(0.05)

        # 1. direct  2. routed
        direct, _, _ = _load_run(serving, A, vocab)
        routed, routed_gen, _ = _load_run(serving, R, vocab)
        _, rstats = http(R + "/healthz")
        by = [r.get("served_by") for r in routed_gen.results]
        line["direct"] = _load_numbers(direct)
        line["routed"] = dict(_load_numbers(routed),
                              served_by={"A": by.count(A),
                                         "B": by.count(B)},
                              router_latency_p50_s=rstats["latency_p50_s"],
                              router_latency_p99_s=rstats["latency_p99_s"])
        line["router_adds_ms"] = {
            q: (routed[f"client_server_delta_{q}_s"]
                - direct[f"client_server_delta_{q}_s"]) * 1e3
            for q in ("p50", "p99")}

        # 3. failover: B SIGKILLed after the run's 4th completion
        kill = {}

        def watch_down():
            while _replica_state(R, B)["state"] != "down":
                time.sleep(0.005)
            kill["down"] = time.monotonic()

        def kill_b(n):
            if n == 4:
                kill["launches"] = _launches(B)
                os.kill(procs["B"].p.pid, signal.SIGKILL)
                kill["t"], kill["wall"] = time.monotonic(), time.time()
                kill["watch"] = threading.Thread(target=watch_down,
                                                 daemon=True)
                kill["watch"].start()

        failover, fo_gen, stamps = _load_run(serving, R, vocab, kill_b)
        check("t" in kill, "router phase: B was never killed")
        kill["watch"].join(timeout=60)
        check("down" in kill, "router phase: B never marked down")
        procs["B"].p.wait(timeout=60)
        _, metrics = http(R + "/metrics")
        validate_exposition_text(metrics)
        failovers = _metric(metrics, "dmlc_router_failovers_total")
        check(failovers >= 1, f"router phase: {failovers} failovers")
        # the torn requests: a dispatch to B cut on the wire
        _, chrome = http(R + "/trace")
        torn = sorted({e["args"]["trace_id"] for e in chrome
                       if e.get("name") == "router.dispatch"
                       and (e.get("args") or {}).get("replica") == B
                       and e["args"].get("outcome") == "transport"})
        check(torn, "router phase: no torn dispatch to B in /trace")
        check({"s", "f"} <= {e.get("ph") for e in chrome},
              "router phase: /trace without flow arrows")
        one_trace = None
        for tid in torn:
            _, tl = http(R + f"/trace/{tid}")
            disp = {e["args"].get("replica"): e["args"].get("outcome")
                    for e in tl["events"] if e["name"] == "router.dispatch"}
            on_a = [e["name"] for e in tl["events"] if e["source"] == A
                    and str(e["cat"]).startswith("serving")]
            if disp.get(B) == "transport" and disp.get(A) == "ok" and on_a:
                one_trace = {"trace_id": tid, "sources": tl["sources"],
                             "dispatches": disp,
                             "survivor_spans": sorted(set(on_a)),
                             "summary": tl["summary"]}
                break
        check(one_trace is not None,
              f"router phase: no torn request is one trace over {torn}")
        moved = [t for t, tid, _ in stamps if tid in set(torn)]
        line["failover"] = dict(
            _load_numbers(failover), failovers_total=failovers,
            torn_requests=len(torn), one_trace=one_trace,
            kill_to_down_s=kill["down"] - kill["t"],
            kill_to_first_failed_over_s=min(moved) - kill["t"],
            chrome_events=len(chrome))

        # 4. recovery: B again on its old port; the probe closes the circuit
        procs["B2"] = _replica("B2", env, port=procs["B"].port,
                               model=ROUTER_MODEL)
        procs["B2"].wait_url("serve:")
        deadline = time.monotonic() + 60
        while _replica_state(R, B)["state"] != "healthy":
            check(time.monotonic() < deadline, "router phase: B never "
                  "healthy again")
            time.sleep(0.005)
        t_healthy = time.monotonic()
        listen_to_healthy = t_healthy - procs["B2"].t_listen
        check(listen_to_healthy <= ROUTER_PROBE_MAX_S
              + 2 * ROUTER_HEALTH_S + 1.0,
              f"router phase: B healthy {listen_to_healthy:.2f} s after it "
              f"listened (probe backoff at most {ROUTER_PROBE_MAX_S} s)")
        rng = np.random.default_rng(1)
        served, bursts = [], 0
        while B not in served:
            check(bursts < 10, f"router phase: B served none of {served}")
            bursts += 1
            res = {}
            ts = [threading.Thread(target=lambda i=i: res.setdefault(i, http(
                R + "/generate", {"prompt": rng.integers(
                    0, vocab, 17 + 8 * i).tolist(), "max_tokens": 8})))
                for i in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=300)
            check(len(res) == 4 and all(c == 200 for c, _ in res.values()),
                  f"router phase: recovery burst {res}")
            served += [d["served_by"] for _, d in res.values()]
        line["recovery"] = {
            "restart_to_listen_s": procs["B2"].t_listen - procs["B2"].t_spawn,
            "restart_to_healthy_s": t_healthy - procs["B2"].t_spawn,
            "listen_to_healthy_s": listen_to_healthy,
            "requests_until_b": len(served)}

        # 5. drain: SIGTERM to A after the run's 4th completion
        drain = {}

        def term_a(n):
            if n == 4:
                drain["launches"] = _launches(A, into=drain)
                os.kill(procs["A"].p.pid, signal.SIGTERM)
                drain["t"], drain["wall"] = time.monotonic(), time.time()

        drained, dr_gen, stamps = _load_run(serving, R, vocab, term_a)
        check("t" in drain, "router phase: A was never drained")
        rc_a = procs["A"].p.wait(timeout=120)
        t_exit = time.monotonic()
        with open(procs["A"].log_path) as f:
            a_log = f.read()
        _, metrics = http(R + "/metrics")
        validate_exposition_text(metrics)
        http_503 = _metric(metrics, "dmlc_router_http_503")
        check(rc_a == 0 and "drained, exiting" in a_log and http_503 == 0,
              f"router phase: drain: A exit {rc_a}, {http_503} 503s")
        after = [t for t, _, _ in stamps if t > drain["t"]]
        from_a = [t for t, _, by_ in stamps if t > drain["t"] and by_ == A]
        line["drain"] = dict(
            _load_numbers(drained), http_503=http_503,
            failovers_total=_metric(metrics, "dmlc_router_failovers_total"),
            a_at_sigterm={k: drain[k] for k in ("active", "waiting")},
            # what each request of the run met, from its trace
            dispatches=_dispatches(R, sorted({tid for _, tid, _ in stamps}),
                                   {A: "A", B: "B"}, drain["wall"]),
            drain_shifts=_metric(metrics, "dmlc_router_drain_shifts"),
            drain_to_last_200_s=max(after) - drain["t"],
            drain_to_last_200_from_a_s=(max(from_a) - drain["t"]
                                        if from_a else None),
            drain_to_exit_s=t_exit - drain["t"])

        # K1 and K4 in every replica that served, from its warm-up on
        final_b2 = _launches(procs["B2"].url)
        per = {"A": {k: drain["launches"][k] - base["A"][k]
                     for k in base["A"]},
               "B": {k: kill["launches"][k] - base["B"][k]
                     for k in base["B"]},
               "B2": final_b2}
        check(all(v > 0 for d in per.values() for v in d.values()),
              f"router phase: a replica without K1 or K4 launches: {per}")
        line["launches"] = per
        launches = {k: sum(d[k] for d in per.values()) for k in per["A"]}
        line["counters"] = {k: _metric(metrics, f"dmlc_router_{k}")
                            for k in ("requests", "completed", "dispatches",
                                      "retries", "failovers_total",
                                      "replica_down_total",
                                      "probe_recoveries", "drain_shifts",
                                      "failed")}
        os.kill(procs["R"].p.pid, signal.SIGTERM)
        os.kill(procs["B2"].p.pid, signal.SIGTERM)
        line["exit_codes"] = {n: procs[n].p.wait(timeout=120)
                              for n in ("R", "B2")}
        check(line["exit_codes"] == {"R": 0, "B2": 0},
              f"router phase: exits {line['exit_codes']}")
    finally:
        left = [n for n, p in procs.items() if p.kill()]
    for url in (A, B, R):
        try:
            http(url + "/healthz", timeout=5)
            still = True
        except (urllib.error.URLError, OSError):
            still = False
        check(not still, f"router phase: {url} still answers")
    check(not left, f"router phase: processes left behind: {left}")
    check(_dmlc_shm() <= shm0, "router phase: /dev/shm/dmlc* left behind")
    line["wall_s"] = time.perf_counter() - t_phase
    return line, launches


# ---------------------------------------------------------------------------
# phase 8d: the fleet — the port's autoscaler over the port's router funds a
# third flagship replica by preempting a rank of a background elastic
# training job, drains it when the load is gone, and the job grows back
# ---------------------------------------------------------------------------

FLEET_FEATURES, FLEET_RECORDS, FLEET_STEPS = 7, 240, 50
FLEET_HOLDS = (20, 40)     # both ranks park at each until the harness says go
FLEET_LAYERS = 2           # the replicas: the flagship's widths at depth 2
FLEET_LR, FLEET_PACE_S = 0.05, 0.2
FLEET_LOSS_RTOL = 1e-6                    # rank 0's losses vs the oracle
FLEET_W_TOL = dict(rtol=1e-6, atol=1e-9)  # the final weights vs the oracle
FLEET_SCALER = dict(interval_s=0.3, high_water=0.7, low_water=0.15,
                    hysteresis=2, cooldown_s=3.0, min_replicas=2,
                    max_replicas=3)
# the job's own tracker: a beat late by seconds on a loaded host must not
# declare a parked rank dead (the victim leaves by the remove list)
FLEET_MISS_WINDOW_S, FLEET_GRACE_S = 6.0, 2.0
FLEET_JOB_ENV = {"DMLC_COLL_SHM_TIMEOUT_S": "12",
                 "DMLC_CLIENT_OP_TIMEOUT_S": "120"}
FLEET_SPIKE = dict(n_streams=16, requests_per_stream=6, prompt_len=(17, 511),
                   max_tokens=32, seed=0)
FLEET_TAIL = dict(n_streams=2, requests_per_stream=10, prompt_len=(17, 511),
                  max_tokens=32, seed=1)
FLEET_TENANT_STREAMS, FLEET_TENANT_REQUESTS = 3, 4   # a tenant, a stream
FLEET_TIMEOUT_S = 300     # bound on each wait of the phase
#: the card's run; ``tests/test_torch_fleet.py`` passes a tiny model on the
#: CPU, with ``dir`` and ``log_dir`` under its own temporary directory
FLEET_RUN = dict(model=("--model", "flagship", "--layers", str(FLEET_LAYERS)),
                 device="cuda", dir=None, log_dir=None)
FLEET_CHAIN = ("autoscale_verdict", "preempt_acquire", "preempt_kill_rank",
               "preempt_resize", "preempt_replica_added", "scale_up")
FLEET_RESTORE = ("autoscale_verdict", "preempt_release",
                 "preempt_relaunch_rank", "preempt_restore_resize",
                 "scale_down")


def fleet_rows():
    """The job's records: 7 features and a label a row, float32, from seed
    42 (the reference fleet smoke's data)."""
    rng = np.random.default_rng(42)
    w_true = rng.standard_normal(FLEET_FEATURES)
    x = rng.standard_normal((FLEET_RECORDS, FLEET_FEATURES))
    y = x @ w_true + 0.01 * rng.standard_normal(FLEET_RECORDS)
    return np.concatenate([x, y[:, None]], axis=1).astype(np.float32)


def fleet_oracle(rows):
    """The uninterrupted full-batch trajectory in numpy float64: the loss
    before each step and the final weights."""
    m = rows.astype(np.float64)
    x, y = m[:, :FLEET_FEATURES], m[:, FLEET_FEATURES]
    w = np.zeros(FLEET_FEATURES)
    losses = []
    for _ in range(FLEET_STEPS):
        r = x @ w - y
        losses.append(0.5 * float(r @ r) / len(y))
        w = w - FLEET_LR * (x.T @ r) / len(y)
    return losses, w


def fleet_worker(argv) -> int:
    """One rank of the fleet phase's background job (``chip_smoke.py
    --fleet-worker``, env ``FLEET_DIR``, ``FLEET_DEVICE`` and the tracker's):
    full-batch least squares over its partition of ``data.rec``, the
    gradient and loss in float64 on ``FLEET_DEVICE`` and summed over the
    world by ``TrackerClient.allreduce_sum``; rank 0 checkpoints every step
    and logs its loss.  Both ranks park at each hold step until the
    harness writes ``resume.<step>`` (a ``parked.<rank>.<step>`` file says
    they are there), servicing resizes meanwhile."""
    sys.path.insert(0, ROOT)
    from dmlc_tpu_torch.checkpoint import CheckpointManager
    from dmlc_tpu_torch.io import input_split
    from dmlc_tpu_torch.telemetry import HeartbeatSender
    from dmlc_tpu_torch.tracker.client import TrackerClient, WorldResized

    del argv
    root = os.environ["FLEET_DIR"]
    device = torch.device(os.environ["FLEET_DEVICE"])
    manager = CheckpointManager(os.path.join(root, "ckpt"), max_to_keep=3)

    def load_part(rank, world):
        split = input_split.create(os.path.join(root, "data.rec"), rank,
                                   world, "recordio", threaded=False)
        rows = [np.frombuffer(bytes(r), np.float32) for r in split]
        split.close()
        m = (np.stack(rows) if rows else
             np.zeros((0, FLEET_FEATURES + 1), np.float32))
        m = torch.from_numpy(m.astype(np.float64)).to(device)
        return m[:, :FLEET_FEATURES], m[:, FLEET_FEATURES]

    def grad_and_loss(x, y, w):
        r = x @ torch.from_numpy(w).to(device) - y
        return torch.cat([x.T @ r, x.new_tensor([len(y)]),
                          (0.5 * (r @ r)).reshape(1)]).cpu().numpy()

    c = TrackerClient().start()
    hb = HeartbeatSender(c, interval=0.2)
    hb.send_once()
    w, step = np.zeros(FLEET_FEATURES), 0
    x, y = load_part(c.rank, c.world_size)
    need_sync = True
    while step < FLEET_STEPS:
        try:
            if need_sync:
                if c.rank == 0:
                    got, restored = manager.restore_latest({"w": w})
                    if got is not None:
                        w, step = restored["w"].astype(np.float64), got
                    payload = np.concatenate([w, [float(step)]])
                else:
                    payload = np.zeros(FLEET_FEATURES + 1)
                payload = c.broadcast(payload, root=0)
                w, step = payload[:FLEET_FEATURES], int(payload[-1])
                x, y = load_part(c.rank, c.world_size)
                with open(os.path.join(root, f"rank.{c.rank}"), "w") as f:
                    f.write(str(os.getpid()))
                need_sync = False
            for hold in FLEET_HOLDS:
                if step == hold and not os.path.exists(
                        os.path.join(root, f"resume.{hold}")):
                    open(os.path.join(root, f"parked.{c.rank}.{hold}"),
                         "w").close()
                    while not os.path.exists(
                            os.path.join(root, f"resume.{hold}")):
                        c.check_resized()
                        time.sleep(0.1)
            c.check_resized()
            tot = c.allreduce_sum(grad_and_loss(x, y, w))
        except WorldResized:
            c.resize()
            need_sync = True
            continue
        w = w - FLEET_LR * tot[:FLEET_FEATURES] / tot[FLEET_FEATURES]
        loss = tot[FLEET_FEATURES + 1] / tot[FLEET_FEATURES]
        step += 1
        if c.rank == 0:
            manager.save(step, {"w": w})
            with open(os.path.join(root, "loss.log"), "a") as f:
                f.write(f"{step} {loss:.17e}\n")
        time.sleep(FLEET_PACE_S)
    if c.rank == 0:
        np.save(os.path.join(root, "w_final.npy"), w)
    hb.close()
    c.shutdown()
    return 0


def _fleet_losses(root):
    losses = {}
    path = os.path.join(root, "loss.log")
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) == 2:
                    losses[int(parts[0])] = float(parts[1])  # last wins
    return losses


def _fleet_wait(cond, what, deadline, scaler=None):
    while not cond():
        check(time.monotonic() < deadline, f"fleet phase: {what}"
              + (f"; /fleet {json.dumps(scaler.report())}" if scaler else ""))
        time.sleep(0.05)


def _chain_at(decisions, chain, verdict, start=0):
    """Indexes of ``chain`` as an in-order subsequence of ``decisions``
    from ``start`` (the verdict must be ``verdict``), or None."""
    hits, k = [], 0
    for i in range(start, len(decisions)):
        if k == len(chain):
            break
        d = decisions[i]
        if d.get("kind") != chain[k] or (
                chain[k] == "autoscale_verdict"
                and d.get("verdict") != verdict):
            continue
        hits.append(i)
        k += 1
    return hits if k == len(chain) else None


def fleet_phase(smi, serving, vocab, run=None):
    """Two flagship replicas behind the port's ``Router`` and ``Autoscaler``
    while a 2-rank elastic job trains beside them: a spike preempts rank 1
    to fund a third replica, the tail sees it drained, the job grows back
    and finishes on the oracle's losses, then two tenants share a bucket
    (see the module docstring's ``fleet`` entry for the gates).  Returns
    the phase's line and K1/K4 launches summed over the three replicas
    (zeros on the CPU, where the replicas run the plain versions)."""
    from dmlc_tpu_torch import telemetry as tele
    from dmlc_tpu_torch.fleet import (Autoscaler, ResizeClient,
                                      TrainingPreemptingProvider)
    from dmlc_tpu_torch.io.recordio import RecordIOWriter
    from dmlc_tpu_torch.io.stream import Stream
    from dmlc_tpu_torch.serving.router import (Router, RouterHTTPServer,
                                               TenantGovernor)
    from dmlc_tpu_torch.telemetry import tracecontext
    from dmlc_tpu_torch.telemetry.exporters import validate_exposition_text
    from dmlc_tpu_torch.tracker import RabitTracker

    run = {**FLEET_RUN, **(run or {})}
    card = run["device"] == "cuda"
    root = run["dir"] or os.path.join(ROOT, "build", "fleet")
    log_dir = run["log_dir"] or os.path.join(ROOT, "chiprun_out")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    os.makedirs(log_dir, exist_ok=True)
    t_phase = time.perf_counter()
    shm0 = _dmlc_shm()
    tele.reset()
    tele.reset_events()
    tracecontext.reset_decisions()
    env = _fleet_env()
    if not card:   # the CPU run shares its host with the caller's tests
        env["OMP_NUM_THREADS"] = "1"
    line = {"phase": "fleet", "card": smi, "model": run["model"][1],
            "replica_args": list(run["model"]),
            "scaler": dict(FLEET_SCALER), "spike": dict(FLEET_SPIKE),
            "tail": dict(FLEET_TAIL), "job": {
                "features": FLEET_FEATURES, "records": FLEET_RECORDS,
                "steps": FLEET_STEPS, "holds": list(FLEET_HOLDS),
                "lr": FLEET_LR, "pace_s": FLEET_PACE_S,
                "device": run["device"]}}

    rows = fleet_rows()
    with Stream.create(os.path.join(root, "data.rec"), "w") as s:
        writer = RecordIOWriter(s)
        for row in rows:
            writer.write_record(row.tobytes())
    oracle, oracle_w = fleet_oracle(rows)

    tracker = RabitTracker("127.0.0.1", 2, metrics_port=0,
                           miss_window_s=FLEET_MISS_WINDOW_S, elastic=True,
                           elastic_grace_s=FLEET_GRACE_S)
    tracker.start(2)
    metrics_url = f"http://127.0.0.1:{tracker.metrics_port}"
    workers, logs = [], []

    def spawn_worker(task):
        log = open(os.path.join(log_dir, f"fleet_worker_{task}.log"), "w")
        logs.append(log)
        wenv = dict(env, **FLEET_JOB_ENV, FLEET_DIR=root,
                    FLEET_DEVICE=run["device"],
                    DMLC_TRACKER_URI="127.0.0.1",
                    DMLC_TRACKER_PORT=str(tracker.port),
                    DMLC_TASK_ID=str(task))
        workers.append(subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--fleet-worker"], cwd=ROOT, env=wenv, stdout=log,
            stderr=subprocess.STDOUT, start_new_session=True))

    def elastic():
        return http(metrics_url + "/healthz", timeout=30)[1]["elastic"]

    procs, marks, drained = {}, {}, {}
    resizes = []
    router = server = scaler = None

    class TimedResize(ResizeClient):
        def resize(self, world, remove=None):
            t0 = time.time()
            doc = super().resize(world, remove)
            resizes.append({"world": world, "remove": remove, "t0": t0,
                            "t1": time.time()})
            return doc

    def kill_rank(rank):
        with open(os.path.join(root, f"rank.{rank}")) as f:
            pid = int(f.read())
        marks["kill0"] = time.time()
        os.kill(pid, signal.SIGKILL)
        victim = next(p for p in workers if p.pid == pid)
        victim.wait(timeout=60)
        marks.update(kill1=time.time(), victim_pid=pid)

    def launch_replica(rank):
        del rank
        marks["spawn"] = time.time()
        procs["C"] = _replica("C", env, model=run["model"], log_dir=log_dir)
        url = procs["C"].wait_url("serve:")
        marks["listen"] = time.time()
        code, doc = http(url + "/generate", {"prompt": list(range(1, 18)),
                                             "max_tokens": 8})
        marks["warm"] = time.time()
        if card:
            marks["c_base"] = _launches(url)
        check(code == 200, f"fleet phase: C's warm-up {code} {doc}")
        return url

    def stop_replica(url):
        marks["stop"] = time.time()
        if card:
            marks["c_end"] = _launches(url)
        os.kill(procs["C"].p.pid, signal.SIGTERM)
        drained["rc"] = procs["C"].p.wait(timeout=240)
        marks["exit"] = time.time()
        with open(procs["C"].log_path) as f:
            drained["line"] = "drained, exiting" in f.read()

    def relaunch_rank(rank):
        marks["relaunch"] = time.time()
        spawn_worker(10 + rank)

    try:
        for task in range(2):
            spawn_worker(task)
        procs["A"] = _replica("A", env, model=run["model"], log_dir=log_dir)
        procs["B"] = _replica("B", env, model=run["model"], log_dir=log_dir)
        A, B = procs["A"].wait_url("serve:"), procs["B"].wait_url("serve:")
        line["replica_start_s"] = {n: procs[n].t_listen - procs[n].t_spawn
                                   for n in ("A", "B")}
        for url in (A, B):
            code, doc = http(url + "/generate", {"prompt": list(range(1, 18)),
                                                 "max_tokens": 8})
            check(code == 200, f"fleet phase: warm-up at {url}: {doc}")
        base = {"A": _launches(A), "B": _launches(B)} if card else {}
        deadline = time.monotonic() + FLEET_TIMEOUT_S
        _fleet_wait(lambda: all(os.path.exists(os.path.join(
            root, f"parked.{r}.{FLEET_HOLDS[0]}")) for r in (0, 1)),
            f"the job's 2 ranks never parked at step {FLEET_HOLDS[0]}",
            deadline)
        check(tracker.error is None, f"fleet phase: tracker {tracker.error}")
        el0 = elastic()
        check(el0["world"] == 2, f"fleet phase: job world {el0}")

        gov = TenantGovernor(rate=0.0, burst_s=1.0,
                             weights={"paid": 50.0, "free": 1.0})
        router = Router([A, B], health_interval_s=ROUTER_HEALTH_S,
                        probe_base_s=ROUTER_HEALTH_S,
                        probe_max_s=ROUTER_PROBE_MAX_S, retries=3,
                        dispatch_timeout_s=120.0, request_timeout_s=240.0,
                        tenants=gov)
        registered = threading.Event()
        add, set_draining = router.add_replica, router.set_draining

        def added(url):
            rep = add(url)
            marks["registered"] = time.time()
            registered.set()
            return rep

        def draining(url):
            marks["draining"] = time.time()
            return set_draining(url)

        router.add_replica, router.set_draining = added, draining
        provider = TrainingPreemptingProvider(
            TimedResize(metrics_url), full_world=2, kill_rank=kill_rank,
            launch_replica=launch_replica, stop_replica=stop_replica,
            relaunch_rank=relaunch_rank, min_world=1)
        scaler = Autoscaler(router, provider, **FLEET_SCALER)
        server = RouterHTTPServer(router, port=0,
                                  fleet_source=lambda: scaler)
        R = server.url
        _fleet_wait(lambda: router.counts()["healthy"] == 2,
                    "the router never saw 2 healthy replicas",
                    time.monotonic() + 60)
        scaler.start()

        # the spike: each stream's last request waits until the scaled
        # replica is registered (no wait when it landed before), so the
        # third replica takes part of it however fast the first five are
        waits = []
        last = FLEET_SPIKE["requests_per_stream"]
        mine = threading.local()

        class Spike(serving.LoadGenerator):
            def _post(self, doc, headers=None):
                ids = mine.__dict__.setdefault("ids", set())
                if doc["request_id"] not in ids:
                    ids.add(doc["request_id"])
                    if len(ids) == last and not registered.is_set():
                        t0 = time.monotonic()
                        registered.wait(FLEET_TIMEOUT_S)
                        with self._lock:
                            waits.append(time.monotonic() - t0)
                return super()._post(doc, headers)

        spike = Spike(R, vocab=vocab, **FLEET_SPIKE)
        spike_sum = {}
        runner = threading.Thread(target=lambda: spike_sum.update(
            spike.run()), daemon=True)
        runner.start()
        deadline = time.monotonic() + FLEET_TIMEOUT_S
        _fleet_wait(lambda: scaler.report()["counters"]["scale_ups"] >= 1,
                    "the spike never triggered a scale-up", deadline, scaler)
        rep = scaler.report()
        st = rep["provider"]
        el1 = elastic()
        check(rep["replicas"] == 3 and len(rep["owned"]) == 1
              and st["training_world"] == 1 and st["preemptions"] == 1
              and el1["world"] == 1,
              f"fleet phase: scale-up: {json.dumps(rep)}, tracker {el1}")
        C = rep["owned"][0]
        open(os.path.join(root, f"resume.{FLEET_HOLDS[0]}"), "w").close()
        runner.join(FLEET_TIMEOUT_S)
        check(not runner.is_alive(), "fleet phase: the spike wedged")
        n_spike = FLEET_SPIKE["n_streams"] * last
        by = [r.get("served_by") for r in spike.results]
        check(spike_sum["n_requests_ok"] == n_spike and not spike.failures
              and spike_sum["n_backoffs_503"] == 0,
              f"fleet phase: spike {spike_sum} {spike.failures[:2]}")
        check(by.count(C) >= 1, "fleet phase: C served none of the spike")
        verdict = next(d for d in tracecontext.decision_log().tail(1024)
                       if d["kind"] == "autoscale_verdict"
                       and d["verdict"] == "scale_up")
        ack = resizes[0]
        line["scale_up"] = {
            "verdict_to_registered_s": marks["registered"] - verdict["t"],
            "verdict_to_kill_s": marks["kill0"] - verdict["t"],
            "kill_s": marks["kill1"] - marks["kill0"],
            "resize_ack_s": ack["t1"] - ack["t0"],
            "spawn_to_listening_s": marks["listen"] - marks["spawn"],
            "warm_up_s": marks["warm"] - marks["listen"],
            "warm_to_registered_s": marks["registered"] - marks["warm"],
            "verdict": {k: verdict[k] for k in (
                "util", "high_streak", "replicas")},
            "tracker": {"world": el1["world"], "gen": el1["gen"]}}
        line["spike"].update(
            _load_numbers(spike_sum), served_by={
                n: by.count(u) for n, u in (("A", A), ("B", B), ("C", C))},
            streams_held=len(waits), held_s_max=max(waits, default=0.0))

        # the tail: the controller drains C and gives the rank back
        tail = serving.LoadGenerator(R, vocab=vocab, **FLEET_TAIL)
        tail_sum = {}
        runner = threading.Thread(target=lambda: tail_sum.update(
            tail.run()), daemon=True)
        runner.start()
        deadline = time.monotonic() + FLEET_TIMEOUT_S
        _fleet_wait(lambda: scaler.report()["counters"]["scale_downs"] >= 1,
                    "scale-down never fired", deadline, scaler)
        _fleet_wait(lambda: elastic()["gen"] > el1["gen"],
                    "the grow generation never opened", deadline)
        marks["grow"] = time.time()
        open(os.path.join(root, f"resume.{FLEET_HOLDS[1]}"), "w").close()
        runner.join(FLEET_TIMEOUT_S)
        check(not runner.is_alive(), "fleet phase: the tail wedged")
        _, metrics = http(R + "/metrics")
        n_tail = FLEET_TAIL["n_streams"] * FLEET_TAIL["requests_per_stream"]
        http_503 = _metric(metrics, "dmlc_router_http_503")
        check(tail_sum["n_requests_ok"] == n_tail and not tail.failures
              and tail_sum["n_backoffs_503"] == 0 and http_503 == 0,
              f"fleet phase: tail {tail_sum} {tail.failures[:2]}, router "
              f"503s {http_503}")
        check(drained.get("rc") == 0 and drained.get("line"),
              f"fleet phase: C's drain: exit {drained.get('rc')}, drain "
              f"line {drained.get('line')} ({procs['C'].log_path})")
        rep = scaler.report()
        check(rep["replicas"] == 2 and not rep["owned"],
              f"fleet phase: after the scale-down {json.dumps(rep)}")
        by = [r.get("served_by") for r in tail.results]
        line["tail"].update(
            _load_numbers(tail_sum),
            served_by={n: by.count(u) for n, u in (("A", A), ("B", B),
                                                   ("C", C))},
            http_503=http_503,
            drain_shifts=_metric(metrics, "dmlc_router_drain_shifts"),
            draining_to_exit_s=marks["exit"] - marks["draining"],
            draining_to_sigterm_s=marks["stop"] - marks["draining"])

        # the job grows back to 2 and finishes on the oracle's numbers
        deadline = time.monotonic() + FLEET_TIMEOUT_S
        _fleet_wait(lambda: elastic()["world"] == 2,
                    "the job never grew back to world 2", deadline)
        el2 = elastic()
        exits = {}
        for p in workers:
            try:
                exits[p.pid] = p.wait(timeout=max(
                    1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                at = max(_fleet_losses(root), default=0)
                check(False, f"fleet phase: worker {p.pid} never finished "
                      f"(loss log at step {at})")
        victim = marks["victim_pid"]
        others = [rc for pid, rc in exits.items() if pid != victim]
        check(exits.get(victim) == -signal.SIGKILL and others == [0, 0],
              f"fleet phase: worker exits {exits} (victim {victim})")
        losses = _fleet_losses(root)
        check(sorted(losses) == list(range(1, FLEET_STEPS + 1)),
              f"fleet phase: loss log steps {sorted(losses)}")
        worst = max(abs(losses[s + 1] - oracle[s]) / abs(oracle[s])
                    for s in range(FLEET_STEPS))
        w_final = np.load(os.path.join(root, "w_final.npy"))
        check(worst <= FLEET_LOSS_RTOL and np.allclose(
            w_final, oracle_w, **FLEET_W_TOL),
            f"fleet phase: loss max rel {worst} (<= {FLEET_LOSS_RTOL}); "
            f"weights {w_final} vs {oracle_w}")
        line["job"].update(
            max_rel_loss_err=worst,
            max_abs_w_err=float(np.abs(w_final - oracle_w).max()),
            worlds=[el0["world"], el1["world"], el2["world"]],
            gens=[el0["gen"], el1["gen"], el2["gen"]],
            resizes=[{k: r[k] for k in ("world", "remove")}
                     | {"ack_s": r["t1"] - r["t0"]} for r in resizes],
            relaunch_to_grow_s=marks["grow"] - marks["relaunch"],
            exits=sorted(exits.values()))

        # two tenants under an enforcing bucket
        gov.rate = 2.0
        fair = serving.LoadGenerator(
            R, vocab=vocab, prompt_len=(17, 64), max_tokens=4, seed=2,
            requests_per_stream=FLEET_TENANT_REQUESTS,
            tenants=[{"tenant": "paid", "streams": FLEET_TENANT_STREAMS,
                      "priority": "interactive"},
                     {"tenant": "free", "streams": FLEET_TENANT_STREAMS,
                      "priority": "batch"}])
        fair_sum = fair.run()
        gov.rate = 0.0
        per = fair_sum.get("tenants") or {}
        check(not fair.failures and {"paid", "free"} <= set(per)
              and per["free"]["n_rejections_429"] >= 1
              and per["paid"]["n_rejections_429"] == 0,
              f"fleet phase: tenants {json.dumps(per)} {fair.failures[:2]}")
        line["tenants"] = {t: {k: per[t][k] for k in (
            "n_requests_ok", "n_rejections_429", "p50_ttft_s", "p99_ttft_s")}
            for t in ("paid", "free")}

        # what the front door shows
        _, text = http(R + "/metrics")
        validate_exposition_text(text)
        for needle in ("dmlc_fleet_replicas 2", "dmlc_fleet_owned_replicas 0",
                       "dmlc_fleet_scale_ups_total 1",
                       "dmlc_fleet_scale_downs_total 1",
                       'dmlc_tenant_admitted_total{tenant="paid"}',
                       'dmlc_tenant_rejected_total{tenant="free"}',
                       'dmlc_tenant_rejected_total{tenant="paid"} 0'):
            check(needle in text, f"fleet phase: {needle} not on /metrics")
        _, fleet_doc = http(R + "/fleet")
        check(fleet_doc["counters"]["scale_ups"] == 1
              and fleet_doc["counters"]["scale_downs"] == 1
              and fleet_doc["provider"]["restores"] == 1,
              f"fleet phase: /fleet {json.dumps(fleet_doc)[:600]}")
        _, dec_doc = http(R + "/decisions")
        dec = dec_doc["decisions"]
        up = _chain_at(dec, FLEET_CHAIN, "scale_up")
        down = up and _chain_at(dec, FLEET_RESTORE, "scale_down",
                                up[-1] + 1)
        check(up and down and dec[up[2]]["victim_rank"] == 1
              and any(d["kind"] == "tenant_rejected"
                      and d.get("tenant") == "free" for d in dec),
              f"fleet phase: /decisions {[d['kind'] for d in dec]}")
        _, inc_doc = http(R + "/incidents")
        episodes = [inc for inc in inc_doc.get("incidents") or ()
                    if set(FLEET_CHAIN) <= set(inc.get("decision_kinds")
                                               or ())]
        check(len(episodes) == 1 and episodes[0].get("summary"),
              f"fleet phase: /incidents {json.dumps(inc_doc)[:800]}")
        line["exposition"] = {
            "fleet": {k: fleet_doc[k] for k in ("counters", "provider",
                                                "last_decision")},
            "decisions": len(dec),
            "chain_seqs": [dec[i]["seq"] for i in up + down],
            "incident": {k: episodes[0].get(k) for k in (
                "id", "duration_s", "summary", "decision_kinds")}}

        # K1 and K4 in all three replicas: A and B from their warm-up on,
        # C from its warm-up to its drain
        launches = {"flash_fwd": 0, "paged_attention": 0}
        if card:
            per_rep = {n: {k: v - base[n][k] for k, v in
                           _launches(u).items()}
                       for n, u in (("A", A), ("B", B))}
            per_rep["C"] = marks["c_end"]
            check(all(v > 0 for d in per_rep.values() for v in d.values())
                  and all(marks["c_end"][k] > marks["c_base"][k]
                          for k in launches),
                  f"fleet phase: K1/K4 launches {per_rep}, C after its "
                  f"warm-up {marks['c_base']}")
            line["launches"] = per_rep
            launches = {k: sum(d[k] for d in per_rep.values())
                        for k in launches}
        scaler.close()
        for n in ("A", "B"):
            os.kill(procs[n].p.pid, signal.SIGTERM)
        line["exit_codes"] = {n: procs[n].p.wait(timeout=120)
                              for n in ("A", "B")}
        check(line["exit_codes"] == {"A": 0, "B": 0},
              f"fleet phase: exits {line['exit_codes']}")
    finally:
        if scaler is not None:
            scaler.close()
        if server is not None:
            server.close()
        if router is not None:
            router.close()
        left = [n for n, p in procs.items() if p.kill()]
        for p in workers:
            try:
                os.killpg(p.pid, signal.SIGKILL)
                left.append(p.pid)
            except ProcessLookupError:
                pass
            p.wait(timeout=60)
        for log in logs:
            log.close()
        tracker.close()
    check(not left, f"fleet phase: processes left behind: {left}")
    check(_dmlc_shm() <= shm0, "fleet phase: /dev/shm/dmlc* left behind")
    shutil.rmtree(root, ignore_errors=True)
    line["wall_s"] = time.perf_counter() - t_phase
    return line, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from dmlc_tpu_torch.models import transformer as tfm
    from dmlc_tpu_torch.ops import _build
    from dmlc_tpu_torch.ops import flash_attention as fa
    from dmlc_tpu_torch.ops import paged_attention as pa
    from dmlc_tpu_torch import serving
    from dmlc_tpu_torch import telemetry as tele

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global T_START
    t_start = T_START = time.perf_counter()

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build
    secs = _build.build_all()
    ptxas = []
    for src in sorted(_build.CSRC.glob("*.cu")):
        log = _build.library_path(src).with_suffix(".log")
        if log.exists():
            ptxas += [ln.strip() for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln]
    sass = sass_mma_counts([_build.library_path(_build.CSRC / name)
                            for name in ("flash_fwd.cu", "flash_bwd.cu")])
    if sass is not None:
        # K1 at D 64/128, normalised or not; K2 and K3 at D 64/128
        check(len(sass) == 8 and all(c["HGMMA"] > 0 for c in sass.values()),
              f"bf16 flash kernels without wgmma: {sass}")
    emit({"phase": "build", "seconds": secs, "ptxas": ptxas,
          "sass_tensor_core_ops": sass})

    # 3. / 4. kernels against their plain versions
    prompt_lens = [int(x) for x in np.linspace(17, 511, 8)]
    k1, k1_err = flash_phase(fa)
    k23, k23_err, k1_train = flash_bwd_phase(fa)
    k4, k4_err = paged_phase(pa, prompt_lens)

    # 5. the slice
    cfg = tfm.flagship_config()
    t0 = time.perf_counter()
    model = tfm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            "cuda")
    torch.cuda.synchronize()
    emit({"phase": "model", "params": tfm.count_params(cfg),
          "init_s": time.perf_counter() - t0,
          "bytes": sum(p.numel() * p.element_size()
                       for p in model.parameters())})
    prompts, looping = slice_prompts(cfg.vocab, prompt_lens)
    serve_batch(serving, model, [prompts[0][:17]], 0)   # warm-up
    fa.FLASH_FWD.launches = 0
    pa.PAGED_ATTENTION.launches = 0
    plain = serve_batch(serving, model, prompts, 0)
    spec = serve_batch(serving, model, looping, 3)
    launches = {"flash_fwd": fa.FLASH_FWD.launches,
                "paged_attention": pa.PAGED_ATTENTION.launches}
    emit({"phase": "slice", "model": "flagship", **_emitted(plain)})
    emit({"phase": "slice_spec", "model": "flagship", **_emitted(spec)})
    emit({"phase": "launches", **launches})
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    # 5b. the gather decode path on the same prompts
    gather_doc, gather_launches = gather_phase(
        serving, fa, pa, tfm, model, prompts, looping,
        {**launches, "outputs": (plain["outputs"], spec["outputs"]),
         "docs": (plain, spec)})
    emit(gather_doc)
    emit(logit_checks(tfm, model, cfg))
    TELEMETRY["serving"] = telemetry_serving(serving, tele, fa, model, cfg)
    # a closed engine's KV pools live until the collector breaks the
    # server's handler-class cycle; free them before training's peak
    gc.collect()
    torch.cuda.empty_cache()

    # 6. training
    train_model, one_step, train_launches, step = train_phase(tfm, fa, tele,
                                                              cfg)
    costs = {site: st["last_cost"] for site, st in _site_stats(tele).items()}
    for site in ("serving.prefill", "serving.decode", "serving.decode_spec",
                 "serving.decode_paged", "train.step"):
        check(costs.get(site) is not None, f"site {site} has no cost")
    long_step = train_long_phase(tfm, cfg, step)
    emit(grad_checks(tfm, cfg))
    emit(profile_phase(tfm, model, cfg, {"train": one_step,
                                         "train_long": long_step}))
    del train_model, one_step, long_step, step
    torch.cuda.empty_cache()

    # 7. the data spine: the train step fed from RecordIO, checkpointed
    spine_docs = spine_phase(tfm, fa, cfg)
    for doc in spine_docs:
        emit(doc)
    spine_launches = spine_docs[0]["launches"]

    # 7l. the serving and feed paths under DMLC_LOCKCHECK and
    # DMLC_RACECHECK: a fresh flagship engine under the load generator,
    # then 4 train steps fed by a DeviceFeed
    gc.collect()
    torch.cuda.empty_cache()
    lock_doc, lock_launches = lockcheck_phase(smi, serving, tele, fa, pa,
                                              tfm, model, cfg)
    emit(lock_doc)

    # 7i. the interleaving explorer: the reverted drain caught and
    # replayed, the five scenarios clean with the drain scenario's engine
    # on the card, then an engine of its key serving on the card
    inter_doc, inter_launches = interleave_phase(smi, serving, fa, pa)
    emit(inter_doc)

    # 7a. remote filesystems: the LM example reads its shard from s3:// and
    # checkpoints to gs:// (emulators in a child process), resumes there
    remote_doc, remote_launches = remote_phase(smi)
    emit(remote_doc)

    # 7b. the model options: save_flash_mlp, routed top-k MoE (served,
    # trained, checked in f32), the self-healing trainer; the dense
    # serving model is freed first (the routed train state takes ~50 GB)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    option_launches = model_options_phase(tfm, serving, fa, pa, tele, cfg,
                                          prompts, looping)
    option_launches["gather"] = gather_launches
    option_launches["remote"] = remote_launches
    option_launches["lockcheck"] = lock_launches
    option_launches["interleave"] = inter_launches

    # 7c. the elastic trainer: 3 workers share the card, one is lost, the
    # world shrinks and grows back (the kernels are built already, so the
    # workers load them)
    gc.collect()
    torch.cuda.empty_cache()
    elastic_doc, option_launches["elastic"] = elastic_phase(smi)
    emit(elastic_doc)

    # 7d. the sharded flagship: 4 ranks of a dp1 x sp2 x tp2 mesh share
    # the card over gloo
    gc.collect()
    torch.cuda.empty_cache()
    mesh_doc, ring_rows, option_launches["mesh"] = mesh_phase(smi, fa)
    emit(mesh_doc)

    # 7e. the rest of the five-axis mesh: gang A (pp2 x dp2, the
    # pipeline, overlap="device", a sharded checkpoint) and gang B (ep2 x
    # tp2, routed experts), 4 ranks each sharing the card over gloo
    gc.collect()
    torch.cuda.empty_cache()
    mesh5_doc, mesh5_rows, option_launches["mesh5"] = mesh5_phase(smi, fa)
    emit(mesh5_doc)

    # 7f. sharded serving: the flagship's engine on a dp2 x tp2 mesh, 4
    # ranks sharing the card over gloo, K1 and K4 on each rank's 8 heads
    gc.collect()
    torch.cuda.empty_cache()
    t_shard = time.perf_counter()
    shard_k1, shard_k4 = shard_kernel_rows(fa, pa, prompt_lens)
    shard_doc, option_launches["shard_serve"], wide_docs = \
        shard_serve_phase(smi, {
            "n_layers": cfg.n_layers,
            "docs": {"slice": plain, "slice_spec": spec,
                     "gather": gather_doc["plain"],
                     "gather_spec": gather_doc["spec"]},
            "outputs": (plain["outputs"], spec["outputs"])}, wide=True)
    shard_doc["phase_s"] = time.perf_counter() - t_shard   # kernel rows too
    emit(shard_doc)

    # 7g. sharded serving on the rest of the mesh, which the same 4 ranks
    # served after 7f: the routed flagship on dp2 x ep2 and the dense
    # flagship on pp2 x tp2, K1 and K4 on each rank's layers and heads;
    # beside one card's runs and shard_serve's
    keys = ("tokens_per_s", "ttft_p50_s", "ttft_p99_s", "step_p50_s")
    moe_doc = next(d for d in RESULTS["lines"]
                   if d.get("phase") == "moe_serve")
    wide_doc, option_launches["shard_serve_wide"] = shard_serve_wide_phase(
        smi, {"one_card": {name: {k: d[k] for k in keys} for name, d in (
            ("dense_paged", plain), ("dense_gather", gather_doc["plain"]),
            ("routed_paged", moe_doc["plain"]))},
            "shard_serve_dp2_tp2": {name: {k: shard_doc["runs"][name][k]
                                           for k in keys}
                                    for name in ("gather", "paged")}},
        docs=wide_docs)
    emit(wide_doc)

    # 8. the sparse text path: LibSVM and CSV through libsvm_feed; then
    # the tracker phase's 4-worker jobs on the same files
    for doc in sparse_phase(smi, spine_docs[2],
                            spine_docs[0]["first_batch_byte_exact"]):
        emit(doc)
    emit({"phase": "telemetry", "card": smi, **TELEMETRY})

    # 8c. the fleet router: two flagship replicas share the card behind
    # the port's router (direct, routed, a kill, a restart, a drain)
    gc.collect()
    torch.cuda.empty_cache()
    router_doc, option_launches["router"] = router_phase(smi, serving,
                                                         cfg.vocab)
    emit(router_doc)

    # 8d. the fleet: the port's autoscaler funds a third replica by
    # preempting a rank of a background elastic job, drains it, and the
    # job grows back
    gc.collect()
    torch.cuda.empty_cache()
    fleet_doc, option_launches["fleet"] = fleet_phase(smi, serving, cfg.vocab)
    emit(fleet_doc)

    # 9. the kernels line: each kernel's launches on its own path (K1 and
    # K4 serving, K2 and K3 training; K1 also runs 16 times per train
    # step), and on the spine's, the routed flagship's and the self-heal
    # runs' paths, each counted from 0 just before it
    kernels = []
    for kname, src, replaces, row, err, path, counts in (
            ("flash_fwd", "dmlc_tpu_torch/ops/csrc/flash_fwd.cu",
             "dmlc_tpu/ops/flash_attention.py:212", k1, k1_err, "serve",
             launches),
            ("flash_bwd_dkv", "dmlc_tpu_torch/ops/csrc/flash_bwd.cu",
             "dmlc_tpu/ops/flash_attention.py:475",
             k23["flash_bwd_dkv"], k23_err["flash_bwd_dkv"], "train",
             train_launches),
            ("flash_bwd_dq", "dmlc_tpu_torch/ops/csrc/flash_bwd.cu",
             "dmlc_tpu/ops/flash_attention.py:501",
             k23["flash_bwd_dq"], k23_err["flash_bwd_dq"], "train",
             train_launches),
            ("paged_attention", "dmlc_tpu_torch/ops/csrc/paged_attention.cu",
             "dmlc_tpu/ops/paged_attention.py:126", k4, k4_err, "serve",
             launches)):
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": replaces, "path": path,
                        "launches": counts[kname],
                        "spine_launches": spine_launches.get(kname, 0),
                        "path_launches": {
                            path_name: counts_.get(kname, 0)
                            for path_name, counts_ in option_launches.items()},
                        "max_abs_err": err, "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    # K1 timed alone at the train step's shapes besides its serving row
    kernels[0]["train_ms"] = {f"B{b}xT{t}": r["ms"]
                              for (b, t), r in k1_train.items()}
    # K1 at the mesh train step's ring-step shape, at both offsets, and at
    # the mesh5 gangs' shapes
    kernels[0]["ring_step"] = ring_rows
    kernels[0]["mesh5_shapes"] = mesh5_rows
    # K1 and K4 at a tp=2 rank's 8 heads (the shard_serve phase)
    kernels[0]["shard_serve_shape"] = shard_k1
    kernels[3]["shard_serve_shapes"] = shard_k4
    # K2 and K3 held against the plain backward at the gangs' shapes
    for kern, errs in ((kernels[1], ("dk", "dv")), (kernels[2], ("dq",))):
        kern["mesh5_shapes"] = {
            gang: {"max_abs_err": max(r["bwd"][f"{e}_max_abs_err"]
                                      for e in errs)}
            for gang, r in mesh5_rows.items()}
    emit({"kernels": kernels})
    RESULTS["total_s"] = time.perf_counter() - t_start
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(RESULTS, f, indent=1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--elastic-worker"]:
        sys.exit(elastic_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(mesh_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--mesh5-worker"]:
        sys.exit(mesh5_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--fleet-worker"]:
        sys.exit(fleet_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--shard-serve-worker"]:
        sys.exit(shard_serve_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--gloo-probe"]:
        sys.exit(gloo_probe_worker(sys.argv[2:]))
    sys.exit(main())
