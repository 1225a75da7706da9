#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py     # the whole check, one card

Phases, each fatal on failure (the script exits non-zero and prints no
result):

1. Card: its name and power limit (nvidia-smi).
2. Build: the native coordination core (g++) and every Hopper kernel
   (one nvcc per csrc/*.cu, all at once), with their build times and
   ptxas reports; any spill in a wgmma kernel (WGMMA_KERNELS) fails.
3. Kernel checks: every kernel against its plain PyTorch version on the
   card, at the flagship shapes (flash and cross-entropy in bf16; RMSNorm
   on every path and kernel variant ``rms_plan`` picks: x [16384, 768]
   and large_config's [8192, 2048], 16383 rows, 1 row, d 1000 and 1001,
   3-D and 1-D, and RMS_VARIANT_SHAPES, each in bf16 and f32 with w f32,
   the plan printed per shape; flash also at
   S 4096 and a ragged S 1000; cross-entropy also at ragged (N, E, V) =
   (300, 256, 1000), and dlogits at (1000, 128, 520) and (256, 784,
   1000)), element by element within the stated tolerances (TOL_*); each
   check must also reject a planted fault (a tile left out of a loop, a
   mask skipped on the diagonal tile or past V, a term dropped, a
   statistic over half a row or over one warp of a row's group, a row's
   tail left out of the sum), so a tolerance loose enough to pass a
   broken kernel fails the run, and two launches of each flash backward
   kernel and of ce_dlogits on the same inputs must agree bit for bit.
   Then CUDA-event times of the kernel, the plain version, one library
   call where PyTorch has one (and cuBLAS's product of the cross-entropy
   kernels' shape as a reference point; RMSNorm at four shapes, x [16384,
   768] and [8192, 2048] in bf16 and f32, each with its device time apart
   from the launch (a CUDA graph of its calls), its eager time and the
   host's time a call),
   and the bound (the least time the card could take: bytes over 3.35 TB/s
   or bf16 operations over 989 TFLOP/s, the H100 SXM peaks at 700 W).
4. RMSNorm entry point: ``rms_norm_pallas`` forward and backward through
   autograd on flagship activations ([16, 1024, 768] bf16, w f32), with
   the launch counts set to 0 just before and read just after: the kernel
   launches exactly once a call.  (No model calls it, in the port as in
   the JAX package, whose models use the plain ``rms_norm``.)
5. Flagship training: a lighthouse, then two replica groups as two
   processes on the one card, each training the flagship transformer (12
   layers, d_model 768, 6 x 128 heads, vocab 32000, seq 1024, batch 16)
   under the fault-tolerant loop (Manager -> pipelined GradientAverager
   over TCPCollective with its defaults: the native ring engine, 2 lanes,
   the f32 wire -> should_commit -> AdamW).  Group 0 starts alone; group 1
   starts after group 0 has committed SOLO_STEPS steps, heals from it over
   HTTPTransport, and both run merged to the same final step; group 0 then
   times plain full_steps (compute alone).  Asserted: every step commits,
   every loss is finite, group 1 healed, both groups end with the same
   params_sha256, both rings ran the native engine on 2 lanes and the f32
   wire, and every kernel of the path launched exactly as often as the
   steps require (flash kernels 12 a step, cross-entropy kernels 1 a step).
   Printed: the averager's last_stats, the merged step's split into the
   train thread's waits for the copies off the card, for the ring and for
   the copies back, and params_sha256 beside the previous tree's
   (PREVIOUS_PARAMS_SHA256, asserted equal; two groups on the f32 wire
   reduce each element by one IEEE sum and one division by 2 on any engine,
   lanes or stripes, and the speculative step changes nothing in the
   arithmetic).  ``TrainStep`` runs with the default ``overlap_commit=None``:
   printed, each group's resolved choice after its first committed step,
   the copy's extra bytes, the card's free memory, the process's limit and
   the allocator's peak, and how many steps speculated.
   Each group writes a metrics stream (``TPUFT_METRICS_PATH``) and dumps
   its ring's sampled hops; the port's own consumers then read them:
   asserted, every committed step has a ``step_summary``, group 1's heal a
   ``heal`` span and group 0's snapshot a ``snapshot`` span, each merged
   step's ``allreduce_d2h`` / ``allreduce_merge`` / ``allreduce_h2d`` span
   sums equal the averager's ``last_stats`` waits within SPAN_TOL_MS, and
   ``obs.trace.validate_trace(build_trace(...))`` of both streams and the
   hops is clean; printed, each group's per-step phase table (wall, busy,
   quorum, heal, the three averager phases, commit vote, snapshot and the
   train thread's wait for it), ``obs.report.attribute`` per group, and
   ``report.data_plane`` / ``report.link_attribution`` (the hop stall
   split).  The donor's snapshot: asserted, it was flattened on the HTTP
   transport's background thread, and the train thread's
   ``snapshot_wait`` is under 10% of the ``snapshot`` span; printed, both.
   The heal: asserted, a chunked fetch with every buffer checksum-verified
   on a host with two cores or more; printed, its stripes, workers, GB/s
   and checksum ms, and the donor's checksum stamp.  The worker
   ``/metrics`` endpoint (``TPUFT_WORKER_METRICS_PORT`` 0 on 127.0.0.1):
   each group logs its port and scrapes it over HTTP after the heal step
   and after the last merged step; asserted, it serves, no counter or
   histogram series falls, the hop histograms' ``_count`` is above 0, and
   the ``tpuft_worker_lane_*`` and ``tpuft_worker_hops_total`` series equal
   the ring's ``lane_totals()`` at the scrape; printed, each scrape's bytes,
   lines and ms.
   Then the same schedule a second time with ``TPUFT_RING_TRANSPORT=shm``
   in both groups: asserted as above, and every rank's ring ran on shm
   lanes (``ring_transport``), and the run ends with the TCP run's
   params_sha256 (one IEEE sum and one division by 2 an element, whatever
   carries the bytes); printed, both runs' merged-step splits, and the
   shm run's launches (``launches_main_shm`` in the kernels line).
6. Kill and heal: ``torchft_tpu_torch.launch``'s Launcher runs two groups
   of ``python -m torchft_tpu_torch.examples.train_ddp`` on the card with
   an embedded lighthouse; after group 0 has KILL_MERGED merged commits,
   group 1 is killed with SIGKILL and restarted by the supervisor.
   Asserted: exactly one restart, a heal in the new incarnation, both FINAL
   lines at one step with one params_sha256, every loss finite.  Printed:
   the seconds from the kill to the restarted group's first merged commit,
   the survivor's uncommitted steps, its step ms alone and merged.  Both
   groups write one metrics stream, into which the drive writes a
   ``fault`` record at the kill (asserted); ``obs.report.deadwindow``'s
   dead time is printed beside ``recovery_s``.  Then the disk resume
   (``stop_and_resume``): the same two groups with ``--ckpt_dir`` run to
   RESUME_STEPS and stop, and a second job resumes both from disk.
   Asserted: both groups of the second job print "resumed from disk
   checkpoint step=RESUME_STEPS" and end at twice the steps with one
   params_sha256.
7. Bare ring on the card's host: two in-process ranks allreduce the
   flagship's gradient payload (its parameter count in f32, 537 MB)
   BARE_RING_REPEATS times in each of BARE_RING_CONFIGS: the Python engine
   on 1 lane (the earlier port's ring), the native engine on 2 lanes, the
   bf16 wire on 2 lanes on each engine, and the int8 and int4 wire codecs
   on 2 lanes on each engine; then over shm lanes, both engines on 2
   lanes, the f32 and bf16 wires and int8.  Asserted: the Python and
   native results are bitwise equal on the f32 and bf16 wires and under
   each codec, both ranks hold the same bits, the codecs' sums lie within
   two quantization steps, every ring ran the engine and transport asked
   for, and each shm result is bitwise its TCP twin's.  Then, on the
   native engine's 2 lanes: ``op="max"`` and ``"min"`` (exact); a shaped
   link (``set_link_shaping(SHAPED_MBPS, SHAPED_RTT_MS)`` after an
   unshaped configure; ``lane_stats()["hops"]["flat"]["shape_s"]`` > 0 on
   both ranks, the sum still exact); a RING2D_RANKS-rank ring2d in this
   process (bitwise equal across ranks, within (ranks - 1) roundings of
   2^-24 of the sum of magnitudes of the exact sum, ``tiers`` row and
   col); and allgather, broadcast, reduce_scatter, alltoall, send/recv and
   barrier at 2 ranks, each exact against numpy.  Printed: seconds and
   GB/s of payload per op, the bytes a hop, each op's seconds, each line
   naming the leg that ran beside it (phase 16 (c)).
8. Raw-step profile: ``torchft_tpu_torch.tools.profile_step`` runs
   ``torch.profiler`` over PROFILE_STEPS chained flagship ``full_step``s.
   Printed: wall and device ms a step, the device busy share, the top 20
   ops and the op classes.  Asserted: the trace holds device events, and
   K1-K5 launch 12, 12, 12, 1 and 1 times a step.
9. Semisync codec: the int8 and int4 error-feedback encoders' device
   path (torch ops on the card) against the host quantizers, bit for bit,
   over two rounds with the residual carried: at one 4 MB fragment, at
   the flagship's whole f32 vector, and at 4 MB with NaN and infinities.
   Asserted also: the device path fetches q and the scale only (int8
   bytes + 4), and two planted faults are rejected (a residual not
   carried, the scale one ulp up).  Printed: CUDA-event ms of the device
   encode beside its bound, and the host encode's ms.
10. DiLoCo: a lighthouse and two groups as processes on the card, each
   training the flagship's width at DILOCO_LAYERS (6) of its 12 layers
   with AdamW inner steps through ``TrainStep``
   under ``StreamingDiLoCo(sync_every=8, codec="int8")`` with the default
   4 MB fragments and a synchronous quorum; group 0 runs one round alone,
   group 1 joins, heals the weights, the AdamW state and the outer state,
   and both run two merged rounds.  Asserted: every round commits, every
   loss is finite, both groups end with one params_sha256 and one backup
   hash, K1-K5 launch 6 / 6 / 6 / 1 / 1 times an inner step (counts set
   to 0 before the rounds and read after), the device codec path ran (int8
   bytes + 4 a fragment off the card), each round's wire bytes are at most
   0.27 of f32, the streams hold ``outer_sync`` spans and
   ``obs.trace.validate_trace`` is clean, and one scrape of each group's
   worker ``/metrics`` shows ``tpuft_semisync_*`` beside ``tpuft_worker_*``
   on the Manager's port, with no second port bound.  Printed: inner-step ms with a
   round in flight and in the solo round, the round boundary's and the
   outer apply's ms, the drain waits, wire and D2H bytes a round.
11. Healing: a lighthouse and three groups as processes on the card,
   each training the flagship's widths at HEAL_LAYERS layers under the
   FT loop with the erasure-coded
   plane (TPUFT_EC_K 2, TPUFT_EC_M 1: every committed state encoded on the
   transports' snapshotters and placed over the groups).  (a) Groups 0 and
   1 train merged; group 2 joins and heals striped from both; it then
   fetches the same state once more as one /full stream, chunked from one
   donor and striped from two, timed.  (b) Group 2 is SIGKILLed and
   restarted with TPUFT_EC_MODE=prefer: it heals from the survivors'
   shards.  (c) Group 2 is SIGKILLed and restarted on the donor path;
   group 0's serving link is paced to HEAL_PACE_MBPS and group 0 is
   SIGKILLed HEAL_KILL_DELAY_S after it began streaming a stripe.  Asserted: (a) two donors
   each served stripes and every buffer's checksum was verified, with no
   erasure fallback; (b) one ``ec_reconstruct``, no ``heal_start``, no
   checkpoint request served by the donors; (c) the dead donor's stripes
   failed over to the live one, with no erasure fallback; every merged
   step ends with one params_sha256 on every group that committed it;
   K1-K5 launch HEAL_LAYERS x 3 and 1 / 1 times a step in every process.
   Printed: the fetch modes' seconds and GB/s, the checksum stamp and
   verify ms, the erasure encode and reconstruct ms, the failover heal's
   seconds, each SIGKILL to group 2's first merged commit, each process's
   peak device memory, each line naming the legs that ran beside it
   (phase 17 (a), (b), then phase 16 (a), (b), (d)); phases 12 and 13
   name them beside the times of this phase they print.
12. Elastic: ``torchft_tpu_torch.launch``'s Launcher runs three groups
   (the flagship's widths at ELASTIC_LAYERS layers) of
   this script's ``--elastic-group`` mode and one hot spare on the card
   (its embedded lighthouse with the straggler sentinel and the incident
   watcher in dry-run, one metrics stream, the native 2-lane ring on the
   f32 wire), each training the flagship at full width and depth under
   the elastic batch engine (``TPUFT_ELASTIC_GLOBAL_BATCH`` 48,
   ``TPUFT_ELASTIC_MICROBATCH`` 16: one microstep of 16 a group at three
   participants, 16 + 8 at two).  A group goes through the port's
   ``replica_env()`` (a spare builds the model, starts the card and loads
   the kernels, then waits for its id) and ``make_manager`` (the drain
   watcher attached).  (a) ``Launcher.drain(2)`` while group 2's step is in
   flight: the spare adopts group 2 and heals; (b) SIGKILL of group 1
   ELASTIC_KILL_DELAY_S into a step: the refilled spare adopts it and
   heals; (c) group 0 turns slow, a pid-pinned ``straggle_0.json``
   (``maybe_straggle``, STRAGGLE_SLEEP_S a step in the busy part): the
   lighthouse's sentinel (ELASTIC_LIGHTHOUSE_ENV) alerts, the launcher
   rotates it out to the refilled spare, the watcher bundles the alert.
   Every group scrapes its worker ``/metrics`` after every step (monotonic
   across its reconfigures, lane totals equal to the ring's).  Asserted: (a) the donor commits
   its step in flight, exits 0 through ``complete_drain`` with its marker,
   and the lighthouse's next quorum leaves it out; no survivor fails a
   commit from the first three-way merge to the SIGKILL; every committed
   ``step_summary`` carries ``elastic_global_batch`` 48, the survivors'
   ``elastic_participants`` run 3 -> 2 -> 3 and their steps at two run
   microsteps of 16 and 8; every survivor reconfigure of (a) is
   incremental with the 0 -> 1 edge's lanes reused; the replacement is
   the adopted spare and it healed; (b) one adoption and a heal; every
   merged step ends with one params_sha256; K1-K5 launch ELASTIC_LAYERS
   x 3 and 1 / 1 times a microstep in every process; committed steps ran the
   native 2-lane ring on the f32 wire; (c) an active straggler alert named
   group 0's incarnation, the launcher emitted one ``straggler_drain``, for
   it, the refilled spare adopted group 0 and healed, the sleep stayed with
   the victim's pid, the replacement ran ELASTIC_MERGED merged commits, no
   survivor failed a commit, ``watcher_journal.jsonl`` holds a dry-run
   ``straggler`` drain of group 0 and a bundle's verdict names it.
   Printed: each transition's ``obs.report.deadwindow`` dead time, its
   reconfigures' modes and ms, the drain notice to the donor's exit,
   adoption and fault to the first merged commit (the SIGKILL's beside
   phases 6 and 11's cold restarts), each process's peak device memory;
   (c)'s injection to the alert (seconds and the victim's steps), the
   alert to ``straggler_drain``, the notice to the donor's exit, the
   adoption to the first merged commit, the merged step's wall before,
   during and after, the journal and the bundle's verdict; the scrapes'
   ms and bytes.
13. Durable state and isolated communication: a lighthouse and two
   groups of the flagship's widths at DURABLE_LAYERS layers (one seed, the native 2-lane ring on TCP, the f32
   wire), each drawing its batches through a ``StatefulDataLoader`` over a
   seeded host token table (DURABLE_ROWS rows of seq + 1 tokens, the
   loader's position in the saved state), its Manager given a
   ``CollectiveTransport`` through ``set_checkpoint_transport``, every
   membership callback printed.  (a) DURABLE_STEPS merged steps without
   interruption, on a lighthouse of its own while (b)'s first incarnation
   runs beside it.  (b) The same schedule under ``ManagedDiskCheckpoint``
   (every DURABLE_EVERY, keep DURABLE_KEEP): both groups hold at step
   DURABLE_STEPS / 2 once that checkpoint is durable and are SIGKILLed; a
   torn newer file and a stray ``.tmp`` are planted in group 0's directory;
   both restart and resume from disk.  (c) Group 1 is SIGKILLed, its
   directory deleted, and it restarts cold: it heals from group 0 over the
   collective transport.  (d) Group 1 restarts on ``BabyTCPCollective``
   (``max_retries=2``); after DURABLE_MERGED merged commits it SIGKILLs its
   own baby child during an allreduce; it fails its votes until
   ``ExceededMaxRetriesError`` and exits (the membership, and so the quorum
   id, is unchanged: nothing reconfigures, as in the JAX package), and it
   is restarted on the baby collective once more.  Asserted: (a) one
   params_sha256 on both groups; (b) each restored state's sha256 is the
   one taken at its save, the restored model tensors are on the card, the
   loaders resume where they were saved, no heal at the first quorum, and
   both groups end step DURABLE_STEPS with (a)'s params_sha256; each
   checkpoint is the state's bytes; (c) one heal over the collective, its
   ``heal`` span carrying the state's bytes, the healed group's
   params_sha256 equal to group 0's at that step, then DURABLE_MERGED
   merged commits at one params_sha256; every process's membership
   callbacks equal its ``membership_change`` events; (d) the op in flight
   fails within the baby's timeout naming the child's exit code, the
   process keeps its pid, every later vote fails with the latched error,
   group 0's vote at that step fails too, the child is not respawned, the
   process exits with ``ExceededMaxRetriesError``, and after the restart
   DURABLE_MERGED merged commits at one params_sha256; K1-K5 launch
   DURABLE_LAYERS x 3 and 1 / 1 times a step in every process.  Printed: each save's
   bytes, flatten (enqueue), backpressure stall and durable-write ms; the
   restart to "resumed" seconds; the collective heal's seconds and GB/s
   beside phase 11's HTTP striped transfer; the merged step with the baby
   collective against without; the baby's configure ms; the child's
   SIGKILL to the failed op, to the exception, to the exit and to the next
   merged commit.
14. The control plane: two groups of the flagship's widths at
   CONTROL_LAYERS layers (one seed, each step's batch
   seeded by group and step, the native 2-lane TCP f32 ring, Manager
   ``min_replica_size`` 2), each one process running two schedules of
   CONTROL_STEPS steps, and every lighthouse a ``python -m
   torchft_tpu_torch.lighthouse_cli`` process.  (a) Two HA replicas on one
   lease file (``--lease-ms`` CONTROL_LEASE_MS, ``--min_replicas 2``), the
   groups given both addresses; after CONTROL_KILL_AT merged commits of
   each group the leader's process is SIGKILLed; then the port Launcher's
   client evicts group 1 through the two addresses.  (b) A root
   (``--min_replicas 2``) and two regions (``--region r0|r1 --root-addrs``),
   one group in each, the same schedule uninterrupted: (a)'s reference.
   Asserted: the standby leads at the next epoch within 3 lease periods;
   no failed commit; exactly one ``lighthouse_failover`` (the standby's);
   each group's quorum id and ring configure count unchanged across the
   kill, and CONTROL_AFTER merged steps after it; the new leader tracks
   both groups (``tpuft_replica_step``); the evict drops group 1's id; all
   four final params_sha256 equal; the root's ``/regions.json`` has both
   regions fresh and its ``/metrics`` no ``Heartbeat`` RPC and some
   ``RegionDigest`` ones; no lighthouse process holds a ``/dev/nvidia*``
   file (the groups do); K1-K5 launch CONTROL_LAYERS x 3 and 1 / 1 a step.
   Printed: ``takeover_s``, each group's gap between commits across the
   kill and its longest, the quorum ids and configure counts each side of
   the kill, every failed commit, the failover events, the new leader's
   ``tpuft_replica_step``, the evict, each step's quorum span in (b) and
   (a)'s median, the root's ``regions()``, and a ``CONTROL`` summary line
   with the card's name and power limit.
15. The step options on the flagship, in this process.  (a) Two models
   from one seed, with ``remat`` and without, take OPTION_STEPS
   ``full_step``s on the same batches.  Asserted: the losses are bitwise
   equal, the gradients lie within TOL_REMAT_GRAD of each tensor's max
   (printed whether they are bitwise), K1-K5 launch 24, 12, 12, 1 and 1
   times a step with remat and 12, 12, 12, 1 and 1 without, and the peak
   of ``torch.cuda.max_memory_allocated`` is lower with remat.  Printed:
   both peaks and each step's CUDA-event ms.  (b) Two groups from one seed,
   each alone (its own lighthouse, ``min_replica_size`` 1: the averager's
   lone-ring path), one with ``overlap_commit=True`` and one with
   ``False``, take OVERLAP_STEPS ``ft_step``s in turns on the same
   batches; the loss_fn of step OVERLAP_FAIL_AT reports an error, so its
   vote fails.  Asserted: after every step both hold bitwise the same
   parameters and AdamW state, the overlapped one speculated every step and
   restored the failed one, the serial one never speculated.  Printed: each step's wall, its
   ``commit_vote`` span and the snapshot copy's CUDA-event ms.
16. In-group parallelism and sharded healing on the flagship's widths.
   (a) and (b): two local ranks on the card (``chip_smoke.py --hsdp-rank``,
   bootstrapped by ``multihost.initialize_slice`` over gloo, since NCCL
   refuses two ranks on one device); the flagship sharded over {fsdp 2}
   for HSDP_STEPS["fsdp"] SGD steps, then over {tensor 2} for
   HSDP_STEPS["tensor"], each rank on its slice of the batch ("tensor":
   the whole batch), and in rank 0 the same model unsharded on the whole
   batch.  Asserted: each step's mean loss within TOL_HSDP_LOSS of the
   unsharded one and every gathered gradient within TOL_HSDP_GRAD of each
   tensor's max; K1-K5 launch 12 / 12 / 12 / 1 / 1 a rank a step over
   fsdp, K1-K3 12 and K4/K5 0 over tensor, where the loss took the
   vocab-parallel plain path once a step.  (c) ``train_hsdp --model
   flagship``, two groups of {fsdp 2} under the launcher, group 1
   SIGKILLed after HSDP_KILL_AFTER merged commits: its ranks die with it,
   each restarted rank heals its own shards over HTTP from group 0's same
   rank, and both groups end at one step with one ``params_sha256`` over
   the gathered parameters; printed: each rank's heal span and fetch, the
   merged and solo steps, the recovery; (c) runs from a thread beside
   phase 7, and (a), (b) and (d) beside phase 11 (all bound by process
   starts and the heal), so their walls fall there.  (d) one rank on a
   one-rank mesh over NCCL in this process, a lone Manager, HSDP_NCCL_STEPS committed
   ``ft_step``s with K1-K5 12 / 12 / 12 / 1 / 1 a step.
17. The mixture of experts and the pipeline on the flagship's widths.
   (a) and (b): two local ranks on the card (``chip_smoke.py --p17-rank``,
   each with a Manager, over gloo), started beside phase 6 (train_ddp's
   tiny model leaves the card's memory to them; bound by process starts and
   the heal), where they also run phase 19's legs, and read here.  (a) the
   flagship's widths with MOE_EXPERTS experts a block (top 2, capacity
   1.25, batch MOE_BATCH) over {expert 2} against the same model unsharded
   in rank 0: in f32 (the plain path, batch MOE_F32_BATCH) the loss within
   TOL_P17_F32_LOSS, every gathered gradient within TOL_P17_F32_GRAD of its
   tensor's max and no token routed otherwise; in bf16 (the kernels), the
   unsharded model on the sharded run's routing, the loss within
   TOL_P17_LOSS, every gathered gradient within TOL_P17_GRAD, and the
   tokens its own router sends elsewhere within TOL_P17_REROUTE of a
   layer's (see TOL_P17_*); then MOE_FT_STEPS committed
   ``ft_step``s under the Managers; K1-K5 12 / 12 / 12 / 1 / 1 a rank a
   bf16 step; printed, the combine's product at a rank's shapes (moe_ffn's
   f32-output product against the bf16 one and the f32 one of operands
   cast up).  (b) the flagship over {pipeline 2}, GPipe and 1F1B at M
   PIPE_MICRO against the unsharded model's loss and every gradient of the
   stage (TOL_P17_*), K1-K5 a stage a step 24 / 24 / 24 and 1F1B's K1 48
   (the recompute), K4/K5 on the last stage only (GPipe 1, 1F1B M), and at
   M PIPE_MEM_MICRO 1F1B's peak below GPipe's.  (c), run from a thread
   beside phases 9 and 10: ``train_pipeline --model flagship --schedule 1f1b``, two
   groups of {pipeline 2} under the launcher, group 1 SIGKILLed after
   P17_KILL_AFTER merged commits: its ranks die with it, each restarted
   rank heals its own stage from group 0's same rank, and both groups end
   with one ``params_sha256``.
18. Long context on the flagship (its widths, depth and sequence, batch
   P18_BATCH) over {sequence 2}.  (a): two local ranks on the card
   (``chip_smoke.py --p18-rank``, over gloo) run ring attention
   contiguous, ring attention zigzag and Ulysses against the same model
   unsharded (flash) in rank 0, on the same weights and batches: in f32
   (the plain path, batch P18_F32_BATCH) the loss within TOL_P18_F32_LOSS
   and every gradient within TOL_P18_F32_GRAD of its tensor's max, and a
   planted fault in each backend (the ring drops a block, the zigzag ropes
   with contiguous positions, the exchange runs on the wrong dims) must
   fail that check; in bf16 (the kernels, P18_PASSES passes) within
   TOL_P18_LOSS and TOL_P18_GRAD; K1-K5 a rank a pass 12 / 12 / 12 / 1 / 1
   under Ulysses and 0 / 0 / 0 / 1 / 1 under the ring; printed, forward
   and backward ms, the peak and the bytes hopped or exchanged a rank a
   step.  (b) ``train_ring --model flagship --layout zigzag``, two groups
   of {sequence 2} under the launcher, group 1 SIGKILLed after
   P18_KILL_AFTER merged commits: each restarted rank heals its own state
   from group 0's same rank, and both groups end with one
   ``params_sha256``.  (b) then (a) run from a thread beside phases 12-14,
   whose lines say so.
19. The mixture of experts over "tensor" and over "sequence": phase 17's
   MoE model (MOE_BATCH, the flagship's depth and sequence) in phase 17's
   two rank processes after its (a) and (b), (a) over {tensor 2} (each
   rank F / 2 of every expert), (b) over {sequence 2} under Ulysses and
   (c) under the zigzag ring (tokens permuted as phase 18 permutes them),
   each against the same model unsharded in rank 0, which replays the
   sharded run's routing (in zigzag order for (c)): in f32 (the plain
   path, batch MOE_F32_BATCH, capacity factor P19_F32_FACTOR, where tokens
   drop) the loss within TOL_P17_F32_LOSS, every gathered gradient within
   TOL_P17_F32_GRAD and no token routed otherwise, and each leg's planted
   fault (P19_FAULTS: the F-slice's input without ``copy_to``, the slot
   offsets without the other "sequence" ranks' counts) must fail that
   check; in bf16 (MOE_STEPS passes) within TOL_P17_LOSS and TOL_P17_GRAD,
   tokens routed otherwise within TOL_P17_REROUTE; then MOE_FT_STEPS
   committed ``ft_step``s under the Managers; K1-K5 a rank a pass 12 / 12 /
   12 / 0 / 0 over "tensor" (the vocab-parallel loss), 12 / 12 / 12 / 1 / 1
   under Ulysses, 0 / 0 / 0 / 1 / 1 under the ring; printed, forward and
   backward ms, the peak and the dispatch's bytes a layer a rank.
20. The kernels line, ``{"kernels": [...]}`` (RMSNorm's ``device_ms``
   and ``host_ms`` beside ``ms``, and its four shapes under ``shapes``;
   each kernel's launches on
   the phase 5 run, on the DiLoCo run as ``launches_diloco``, on the
   healing run as ``launches_healing``, on the elastic run as
   ``launches_elastic``, on the durable run as ``launches_durable``, on
   the control-plane run as ``launches_control``, on phase 15 (a)'s
   steps with and without remat as ``launches_remat`` and
   ``launches_no_remat``, over phase 16's legs as ``launches_hsdp``, and
   over phase 17's as ``launches_moe``, ``launches_pipeline`` and
   ``launches_train_pipeline``, and over phase 18's as ``launches_ring``
   (contiguous and zigzag), ``launches_ulysses`` and
   ``launches_train_ring``, and over phase 19's as ``launches_moe_tensor``,
   ``launches_moe_ulysses`` and ``launches_moe_zigzag``),
   the run's seconds, then
   the last line, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import itertools
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense, 700 W
PEAK_BYTES_PER_S = 3.35e12
MERGED_STEPS = 3          # steps both groups run with 2 participants
SOLO_STEPS = 4            # steps group 0 commits before group 1 starts
RAW_STEPS = 3             # group 0's plain full_step timings after the run
GROUP_TIMEOUT_S = 600.0
JOIN_GRACE_S = 1.0        # for group 1's first quorum request to reach the lighthouse
RMS_CALLS = 3             # rms_norm_pallas calls of the entry-point phase
RMS_LARGE = (8192, 2048)  # large_config's x (batch 8 x seq 1024, d_model 2048; bench.py:274)
RMS_GRAPH_REPS = 200      # K6 launches in the CUDA graph of its device time
# K6's checked shapes beyond the timed ones, each for a variant of the
# kernel (ops/rmsnorm.py rms_plan, in both dtypes): the ring with 6 vectors
# a lane (bf16) and 4 (f32); groups of 2 and 4 warps a row (bf16), 4 and 8
# (f32), each walking its ring more than once around; 8 warps a row with rows
# wider than their registers hold (the slot kept until the row is written);
# and "vector", rows too wide for a ring.
RMS_VARIANT_SHAPES = ((64, 1536), (64, 512), (4100, 4096), (2640, 8192), (600, 20000),
                      (2, 30000))
L2_BYTES = 50 * 2 ** 20   # the H100's L2: timed inputs rotate through twice it
KILL_STEPS = 2000         # train_ddp's --steps in the kill-and-heal phase
KILL_MERGED = 30          # group 0's merged commits before the kill
KILL_TIMEOUT_S = 420.0
BARE_RING_REPEATS = 1     # allreduces per configuration in the bare-ring phase
BARE_RING_TIMEOUT_S = 300.0
# params_sha256 of phase 5 on the previous tree (the single-lane Python
# ring), printed beside this run's and asserted equal to it.
PREVIOUS_PARAMS_SHA256 = "a6708cb8b8f7ca7d788b7e4aec47ebe288e95de86bd675e5311f02544f344981"
# The averager's span sums per merged step against its last_stats waits:
# one clock measures both, so they differ by rounding (1 us a span) and by
# the Manager's own allreduce_merge span at the vote (the drain of futures
# the averager already resolved).
SPAN_TOL_MS = 1.0
PROFILE_STEPS = 3         # chained raw steps in the profile phase
# The kernels built on wgmma, whose ptxas report must show no spill.
WGMMA_KERNELS = ("flash_fwd_kernel", "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel",
                 "ce_lse_kernel", "ce_dlogits_kernel")


def check_spills(build_logs: dict) -> None:
    """Fails unless ptxas reported 0 bytes of spill for every wgmma kernel:
    a spill inside the warpgroup pipeline serialises the wgmma."""
    from torchft_tpu_torch import _build

    spills = {}
    for log in build_logs.values():
        spills.update(_build.spill_bytes(log))
    for kernel in WGMMA_KERNELS:
        found = {f: b for f, b in spills.items() if kernel in f}
        if not found:
            raise AssertionError(f"no ptxas report for {kernel}")
        if any(found.values()):
            raise AssertionError(f"{kernel} spills: {found} bytes of spill stores + loads")
    print(f"  0 bytes of spill in {', '.join(WGMMA_KERNELS)}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# -- phase 3: kernel checks ---------------------------------------------------


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Device time of one ``fn()``: a CUDA graph of ``reps`` calls, captured
    after a warm-up (outside the capture) and replayed three times; the
    median replay's event time over ``reps``.  The host's work of a call
    (Python, checks, the launch) is left out."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del graph
    return sorted(times)[1] / reps


def host_ms(fn, reps: int = 200) -> float:
    """The host's time of one ``fn()`` while the card trails behind: wall
    time of ``reps`` calls with no synchronisation among them, over
    ``reps`` (the launch queue holds them all).  Where it is below the
    device time, the card sets the pace of calls back to back."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed * 1e3 / reps


def bound(flops: float, nbytes: float) -> dict:
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
    return {
        "bound_ms": max(t_ops, t_mem),
        "bound_by": "operations" if t_ops >= t_mem else "bytes",
        "flops": flops,
        "bytes": nbytes,
    }


# Element-wise tolerances, |got - ref| <= rtol |ref| + row x rms(ref's row)
# + atol, a row being the last axis (one output row of D or V values).
# Flash: bf16 outputs (2^-9 relative) and bf16 P / dS in the products,
# whose rounding scales with the magnitude of the row's terms, not with the
# element; the row term covers that, and a 1e-4 floor the f32 summation
# order where a row is all but zero (the first causal dq row).  A typical
# element in the causal bulk is ~0.05, so the floor is 0.2% of it.
# Cross-entropy dlogits at scale 1: bf16 outputs, logits from the same bf16
# inputs with f32 accumulation; a typical off-target entry is ~2e-5, so the
# floor is 1e-6.
TOL_FLASH = {"rtol": 1e-2, "row": 2e-2, "atol": 1e-4}
TOL_LSE = {"rtol": 0.0, "row": 0.0, "atol": 1e-4}
TOL_DLOGITS = {"rtol": 2e-2, "row": 0.0, "atol": 1e-6}
# RMSNorm's forward: TOL_RMS (bf16 x) and TOL_RMS_F32 in ops/rmsnorm.py,
# which tools/ab_rms_norm.py shares: two bf16 rounding steps, 1.6e-2 |ref|
# + 1e-5, and 1e-5 |ref| + 1e-6 for f32.  Its gradients (closed form
# against autograd's chain, both f32, dx rounded to bf16) add a row term
# for dx's cancellation.
TOL_RMS_GRAD = {"rtol": 1e-2, "row": 1e-3, "atol": 1e-5}


def tol_text(tol: dict) -> str:
    return f"{tol['rtol']:g}|ref| + {tol['row']:g} rms(ref row) + {tol['atol']:g}"


def err_ratio(got, ref, tol: dict):
    """(max |got - ref|, rms(ref), max of |got - ref| over the allowed error,
    share of elements over it); the check passes while the ratio is <= 1."""
    ref = ref.float()
    err = (got.float() - ref).abs()
    allowed = tol["rtol"] * ref.abs() + tol["atol"]
    if tol["row"]:
        allowed += tol["row"] * ref.square().mean(-1, keepdim=True).sqrt()
    over = err / allowed
    return (float(err.max()), float(ref.square().mean().sqrt()), float(over.max()),
            float((over > 1).float().mean()))


def check(name: str, got, ref, tol: dict) -> dict:
    e, rms, ratio, _ = err_ratio(got, ref, tol)
    print(f"  {name}: max_abs_err {e:.3e}, rms(ref) {rms:.3e}, worst err/allowed "
          f"{ratio:.3f} (tolerance {tol_text(tol)})", flush=True)
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: error {ratio:.3f}x the tolerance {tol_text(tol)}")
    return {"max_abs_err": e, "ref_rms": rms, "err_over_tol": ratio, "tol": tol_text(tol)}


def reject(name: str, fault, ref, tol: dict) -> float:
    """A planted fault must fail the same check; returns its worst ratio."""
    _, _, ratio, share = err_ratio(fault, ref, tol)
    print(f"  planted fault {name}: worst err/allowed {ratio:.3f}, "
          f"{share:.4f} of elements over (rejected: {ratio > 1.0})", flush=True)
    if not ratio > 1.0:
        raise AssertionError(f"the check accepts the planted fault {name}")
    return ratio


def kernel_checks() -> dict:
    """Holds each kernel against its plain version, shows that each check
    rejects a planted fault, and returns per-kernel records (error,
    tolerance, times, bound) keyed by kernel name."""
    import torch
    import torch.nn.functional as F

    from torchft_tpu_torch.models import flagship_config
    from torchft_tpu_torch.ops import KERNELS
    from torchft_tpu_torch.ops import attention as A
    from torchft_tpu_torch.ops import cross_entropy as C

    cfg, batch, seq = flagship_config()
    H, D = cfg.n_heads, cfg.d_head
    BH = batch * H
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    scale = D ** -0.5

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(torch.bfloat16)

    rec = {n: {} for n in KERNELS}

    def note(name, **kw):
        rec[name].update(kw)

    def keep(name, r, case):
        """Keeps the case with the largest error relative to its tolerance."""
        if r["err_over_tol"] >= rec[name].get("err_over_tol", -1.0):
            note(name, **r, checked=case)

    def diagonal_unmasked(q, k, v, scale):
        """What a causal forward that skipped the mask on the diagonal tile
        would give: keys above the diagonal but in the q row's own 128-row
        tile stay in the softmax."""
        s = torch.einsum("bqd,bkd->bqk", q, k) * scale
        rows = torch.arange(s.shape[1], device=s.device)[:, None]
        cols = torch.arange(s.shape[2], device=s.device)[None, :]
        keep = (cols <= rows) | (cols // 128 == rows // 128)
        p = torch.softmax(torch.where(keep, s, torch.full_like(s, A._NEG_INF)), dim=-1)
        return torch.einsum("bqk,bkd->bqd", p, v)

    # Flash forward: causal at the flagship shape, and one non-causal case.
    q, k, v = randn(BH, seq, D), randn(BH, seq, D), randn(BH, seq, D)
    for causal in (True, False):
        o, lse = A.flash_fwd(q, k, v, scale, causal)
        o_ref, lse_ref = A._fa_reference(q.float(), k.float(), v.float(), scale, causal)
        keep("flash_fwd", check(f"flash_fwd causal={causal} O", o, o_ref, TOL_FLASH),
             f"O, flagship shape, causal={causal}")
        check(f"flash_fwd causal={causal} lse", lse, lse_ref, TOL_LSE)
        if causal:
            o_bad = A._fa_reference(q.float(), k.float(), v.float(), 1.05 * scale, causal)[0]
            note("flash_fwd", planted={
                "O with the softmax scale 5% high": reject(
                    "O with the softmax scale 5% high", o_bad, o_ref, TOL_FLASH),
                "O with the diagonal tile unmasked": reject(
                    "O with the diagonal tile unmasked",
                    diagonal_unmasked(q.float(), k.float(), v.float(), scale), o_ref, TOL_FLASH),
            })

    def planted_bwd(q, k, v, o, lse, do, dq, dv, rq, rv) -> dict:
        """What a causal backward that skipped one tile of a loop would give:
        dq without kv tile 1 (keys 64-127) in the rows past it, and dv
        without the last q tile in the keys of the second half."""
        s = q.shape[1]
        qf, kf, vf, df = q.float(), k.float(), v.float(), do.float()
        delta = (df * o.float()).sum(-1, keepdim=True)
        t1 = slice(64, 128)
        p = torch.exp(torch.einsum("bqd,bkd->bqk", qf, kf[:, t1]) * scale - lse[..., None])
        ds = p * (torch.einsum("bqd,bkd->bqk", df, vf[:, t1]) - delta) * scale
        dq_part = torch.einsum("bqk,bkd->bqd", ds, kf[:, t1])
        dq_part[:, :128] = 0
        last = slice(s - 64, s)
        sl = torch.einsum("bqd,bkd->bqk", qf[:, last], kf) * scale
        rows = torch.arange(s - 64, s, device=q.device)[:, None]
        cols = torch.arange(s, device=q.device)[None, :]
        pl = torch.where(rows >= cols, torch.exp(sl - lse[:, last, None]), 0.0)
        dv_part = torch.einsum("bqk,bqd->bkd", pl, df[:, last])
        dv_part[:, : s // 2] = 0
        return {
            "dq without kv tile 1": reject("dq without kv tile 1", dq.float() - dq_part, rq,
                                           TOL_FLASH),
            "dv without the last q tile": reject("dv without the last q tile",
                                                 dv.float() - dv_part, rv, TOL_FLASH),
        }

    # Flash backward: flagship S=1024 (causal and not), S=4096 causal, where
    # the TPU package takes its two-pass form, and a ragged S=1000 (not a
    # multiple of the 128-row tiles), which also checks the forward.
    for bh, s, causal in ((BH, seq, True), (BH, seq, False), (8, 4096, True), (8, 1000, True),
                          (8, 1000, False)):
        qq, kk, vv, do = randn(bh, s, D), randn(bh, s, D), randn(bh, s, D), randn(bh, s, D)
        o, lse = A.flash_fwd(qq, kk, vv, scale, causal)
        case = f"S={s} BH={bh} causal={causal}"
        if s % 128:
            o_ref, lse_ref = A._fa_reference(qq.float(), kk.float(), vv.float(), scale, causal)
            keep("flash_fwd", check(f"flash_fwd {case} O", o, o_ref, TOL_FLASH), f"O, {case}")
            check(f"flash_fwd {case} lse", lse, lse_ref, TOL_LSE)
            del o_ref, lse_ref
        dq, dk, dv = A.flash_bwd(qq, kk, vv, o, lse, do, scale, causal)
        rq, rk, rv = A._fa_bwd_reference(
            qq.float(), kk.float(), vv.float(), o.float(), lse, do.float(), scale, causal
        )
        for nm, got, ref, kern in (("dq", dq, rq, "flash_bwd_dq"), ("dk", dk, rk, "flash_bwd_dkdv"),
                                   ("dv", dv, rv, "flash_bwd_dkdv")):
            keep(kern, check(f"flash_bwd {case} {nm}", got, ref, TOL_FLASH), f"{nm}, {case}")
        if (bh, s, causal) == (BH, seq, True):
            faults = planted_bwd(qq, kk, vv, o, lse, do, dq, dv, rq, rv)
            note("flash_bwd_dq", planted={"dq without kv tile 1": faults["dq without kv tile 1"]})
            note("flash_bwd_dkdv",
                 planted={"dv without the last q tile": faults["dv without the last q tile"]})
            # Determinism: a second launch on the same inputs, bit for bit.
            dq2, dk2, dv2 = A.flash_bwd(qq, kk, vv, o, lse, do, scale, causal)
            for kern, same in (("flash_bwd_dq", torch.equal(dq, dq2)),
                               ("flash_bwd_dkdv", torch.equal(dk, dk2) and torch.equal(dv, dv2))):
                print(f"  flash_bwd {case}: two {kern} launches give bitwise equal results: "
                      f"{same}", flush=True)
                if not same:
                    raise AssertionError(f"{kern}: two launches on the same inputs differ")
                note(kern, bitwise_repeat=same)
            del dq2, dk2, dv2
        del qq, kk, vv, do, o, lse, dq, dk, dv, rq, rk, rv
        torch.cuda.empty_cache()

    # Cross-entropy at N=16384, E=768, V=32000.
    N, E, V = batch * seq, cfg.d_model, cfg.vocab_size
    x, w = randn(N, E), randn(E, V, std=E ** -0.5)
    t = torch.randint(0, V, (N,), generator=gen, device=dev)
    lse = C.ce_lse(x, w)
    lse_ref = C._ce_lse_reference(x, w)
    note("ce_lse", **check("ce_lse", lse, lse_ref, TOL_LSE), checked="lse")
    note("ce_lse", planted={"lse without the last vocab tile": reject(
        "lse without the last vocab tile", C._ce_lse_reference(x, w[:, :-64]), lse_ref,
        TOL_LSE)})
    one = torch.ones(1, device=dev)
    dl = C.ce_dlogits(x, w, t, lse_ref, one)
    dl_ref = C._ce_dlogits_reference(x.float(), w.float(), t, lse_ref, 1.0)
    note("ce_dlogits", **check("ce_dlogits (scale 1)", dl, dl_ref, TOL_DLOGITS),
         checked="dlogits at scale 1")
    onehot = torch.zeros_like(dl)
    onehot[torch.arange(N, device=dev), t] = -1.0
    # Consumer warpgroup 1's half of item (row tile 0, column tile 1) left
    # unwritten (here: zero).
    half_zeroed = dl.clone()
    half_zeroed[64:128, 256:512] = 0.0
    note("ce_dlogits", planted={
        "-onehot only": reject("-onehot only", onehot, dl_ref, TOL_DLOGITS),
        "rows 64:128 of columns 256:512 zeroed": reject(
            "rows 64:128 of columns 256:512 zeroed", half_zeroed, dl_ref, TOL_DLOGITS),
    })
    del onehot, half_zeroed
    # Determinism: a second launch on the same inputs, bit for bit.
    same = torch.equal(dl, C.ce_dlogits(x, w, t, lse_ref, one))
    print(f"  ce_dlogits: two launches give bitwise equal results: {same}", flush=True)
    if not same:
        raise AssertionError("ce_dlogits: two launches on the same inputs differ")
    note("ce_dlogits", bitwise_repeat=same)
    del dl, dl_ref, lse_ref
    torch.cuda.empty_cache()

    # Ragged cross-entropy: N and V not multiples of the tiles (the last
    # 256-column vocab tile has 24 zero-filled columns past V).
    n_r, e_r, v_r = 300, 256, 1000
    x_r, w_r = randn(n_r, e_r), randn(e_r, v_r, std=e_r ** -0.5)
    t_r = torch.randint(0, v_r, (n_r,), generator=gen, device=dev)
    case = f"N={n_r} E={e_r} V={v_r}"
    lse_r = C._ce_lse_reference(x_r, w_r)
    padded = -(-v_r // C._COLS_PER_TILE) * C._COLS_PER_TILE - v_r
    pad_fault = torch.logaddexp(lse_r, torch.full_like(lse_r, math.log(padded)))
    note("ce_lse", planted={**rec["ce_lse"]["planted"], "lse with the padding past V as logits 0":
                            reject("lse with the padding past V as logits 0", pad_fault, lse_r,
                                   TOL_LSE)})
    keep("ce_lse", check(f"ce_lse {case}", C.ce_lse(x_r, w_r), lse_r, TOL_LSE), f"lse, {case}")
    dl_r = C.ce_dlogits(x_r, w_r, t_r, lse_r, one)
    dl_r_ref = C._ce_dlogits_reference(x_r.float(), w_r.float(), t_r, lse_r, 1.0)
    keep("ce_dlogits", check(f"ce_dlogits {case} (scale 1)", dl_r, dl_r_ref, TOL_DLOGITS),
         f"dlogits at scale 1, {case}")
    # dlogits at the other edges of its tiles: 64-column boxes wholly past V
    # (V 520 in a 768-column span of tiles), and E not a multiple of the
    # 64-wide chunks (784).
    for n_r, e_r, v_r in ((1000, 128, 520), (256, 784, 1000)):
        x_r, w_r = randn(n_r, e_r), randn(e_r, v_r, std=e_r ** -0.5)
        t_r = torch.randint(0, v_r, (n_r,), generator=gen, device=dev)
        case = f"N={n_r} E={e_r} V={v_r}"
        lse_r = C._ce_lse_reference(x_r, w_r)
        keep("ce_dlogits", check(f"ce_dlogits {case} (scale 1)", C.ce_dlogits(x_r, w_r, t_r, lse_r,
                                                                             one),
                                 C._ce_dlogits_reference(x_r.float(), w_r.float(), t_r, lse_r,
                                                         1.0), TOL_DLOGITS),
             f"dlogits at scale 1, {case}")

    rms_checks(note, keep, gen, N, E)

    # -- times ------------------------------------------------------------
    print("timing (CUDA events, after warm-up):", flush=True)
    causal = True
    pairs = seq * (seq + 1) // 2
    o, lse = A.flash_fwd(q, k, v, scale, causal)
    do = randn(BH, seq, D)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    hs = BH * seq * D * 2  # bytes of one [BH, S, D] bf16 tensor
    rows = BH * seq * 4    # bytes of one [BH, S] f32 tensor
    q4, k4, v4, do4 = (x_.view(batch, H, seq, D) for x_ in (q, k, v, do))

    note("flash_fwd",
         ms=cuda_ms(lambda: A.flash_fwd(q, k, v, scale, causal), 20),
         plain_ms=cuda_ms(lambda: A._fa_reference(q, k, v, scale, causal), 5),
         library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True), 20),
         library_call="scaled_dot_product_attention forward",
         **bound(2 * 2 * pairs * D * BH, 4 * hs + rows))
    dkdv = KERNELS["flash_bwd_dkdv"]
    dqk = KERNELS["flash_bwd_dq"]
    plain_bwd = cuda_ms(lambda: A._fa_bwd_reference(q, k, v, o, lse, do, scale, causal), 3)
    q4r, k4r, v4r = (x_.detach().clone().requires_grad_() for x_ in (q4, k4, v4))
    out4 = F.scaled_dot_product_attention(q4r, k4r, v4r, is_causal=True)
    sdpa_bwd = cuda_ms(
        lambda: torch.autograd.grad(out4, (q4r, k4r, v4r), do4, retain_graph=True), 10
    )
    note("flash_bwd_dkdv",
         ms=cuda_ms(lambda: dkdv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                 lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                 BH, seq, D, scale, 1), 20),
         plain_ms=plain_bwd, library_ms=sdpa_bwd,
         library_call="scaled_dot_product_attention backward (dq, dk, dv together)",
         plain_call="_fa_bwd_reference (dq, dk, dv together)",
         **bound(4 * 2 * pairs * D * BH, 4 * hs + 2 * rows + 2 * hs))
    note("flash_bwd_dq",
         ms=cuda_ms(lambda: dqk(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                                BH, seq, D, scale, 1), 20),
         plain_ms=plain_bwd, library_ms=sdpa_bwd,
         library_call="scaled_dot_product_attention backward (dq, dk, dv together)",
         plain_call="_fa_bwd_reference (dq, dk, dv together)",
         **bound(3 * 2 * pairs * D * BH, 4 * hs + 2 * rows + hs))
    del q4r, k4r, v4r, out4
    lse_ce = C.ce_lse(x, w)
    g = torch.full((1,), 1.0 / N, device=dev)
    note("ce_lse",
         ms=cuda_ms(lambda: C.ce_lse(x, w), 5),
         plain_ms=cuda_ms(lambda: C._ce_lse_reference(x, w), 3),
         library_ms=None,
         # A reference point, not the function: cuBLAS's bf16 product of the
         # same shape, which writes the [N, V] logits K4 never stores.
         matmul_ms=cuda_ms(lambda: torch.matmul(x, w), 5),
         **bound(2 * N * E * V, N * E * 2 + E * V * 2 + N * 4))
    note("ce_dlogits",
         ms=cuda_ms(lambda: C.ce_dlogits(x, w, t, lse_ce, g), 5),
         plain_ms=cuda_ms(lambda: C._ce_dlogits_reference(x, w, t, lse_ce, g), 3),
         library_ms=None,
         # A reference point, not the function: cuBLAS's bf16 product of the
         # same shape, which writes as many bf16 bytes as K5 does.
         matmul_ms=cuda_ms(lambda: torch.matmul(x, w), 5),
         **bound(2 * N * E * V, N * E * 2 + E * V * 2 + 2 * N * 4 + 4 + N * V * 2))
    note("rms_norm", **rms_times(gen, N, E))
    for name, r in rec.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.3f}"
        extra = f"  matmul_ms {r['matmul_ms']:.3f}" if "matmul_ms" in r else ""
        print(f"  {name}: kernel_ms {r['ms']:.3f}  plain_ms {r['plain_ms']:.3f}  "
              f"library_ms {lib}{extra}  bound_ms {r['bound_ms']:.4f} ({r['bound_by']})",
              flush=True)
    bwd = rec["flash_bwd_dkdv"]["ms"] + rec["flash_bwd_dq"]["ms"]
    print(f"  flash backward, flash_bwd_dkdv + flash_bwd_dq: {bwd:.3f} ms against "
          f"scaled_dot_product_attention's backward {sdpa_bwd:.3f} ms", flush=True)
    return rec


def rms_checks(note, keep, gen, n: int, e: int) -> None:
    """K6 against ``_rms_reference`` on every path and kernel variant
    ``rms_plan`` picks, each shape in both dtype pairs: the flagship width
    (x [n, e]) and large_config's (RMS_LARGE), a partial last tile (n - 1
    rows), one row, d 1000 and 1001 (unaligned rows: "scalar"), 3-D and
    1-D inputs, and RMS_VARIANT_SHAPES (the ring's other register
    variants, groups of 2, 4 and 8 warps a row walking their rings several
    times, rows wider than the registers hold, and "vector"); a planted
    fault on the ring path, on a group of several warps, on the unaligned
    path and on "vector"; the backward through autograd against the plain
    version's autograd."""
    import torch

    from torchft_tpu_torch.ops import rmsnorm as R

    dev = torch.device("cuda")
    eps = 1e-6
    sms = R._sms(dev)

    def inputs(shape, dtype):
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        w = 1.0 + 0.1 * torch.randn(shape[-1], generator=gen, device=dev)
        return x, w

    def planted(name, x, w, ref, tol, keep_mask, count):
        """Statistics from the elements of keep_mask only: their sum of x^2
        over count."""
        xf = x.float()
        inv_part = torch.rsqrt((xf.square() * keep_mask).sum(-1, keepdim=True) / count + eps)
        return reject(name, (xf * inv_part * w).to(x.dtype), ref, tol)

    faults = {}
    shapes = ((n, e), RMS_LARGE, (n - 1, e), (1, e), (300, 1000), (300, 1001), (4, 50, e), (e,),
              *RMS_VARIANT_SHAPES)
    for shape in shapes:
        for dtype, tol in ((torch.bfloat16, R.TOL_RMS), (torch.float32, R.TOL_RMS_F32)):
            xs, ws = inputs(shape, dtype)
            d = shape[-1]
            plan = R.rms_plan(xs.numel() // d, d, dtype, sms)
            name = f"x {list(shape)} {str(dtype).split('.')[-1]}"
            ref = R._rms_reference(xs, ws, eps)
            print(f"  rms_norm {name}: path {plan.path} (R {plan.rows_per_tile}, "
                  f"{plan.stages} stages, {plan.warps_per_row} warps a row, {plan.smem_bytes} B "
                  f"shared, {plan.blocks} blocks)", flush=True)
            keep("rms_norm", check(f"rms_norm {name}", R.rms_norm_pallas(xs, ws, eps), ref, tol),
                 f"{name}, w f32")
            if dtype != torch.bfloat16:
                continue
            vec = torch.arange(d, device=dev) // (16 // dtype.itemsize)
            if shape in ((n, e), (300, 1001)):
                case = f"statistics over the first half of each row, {name} ({plan.path})"
                half = (torch.arange(d, device=dev) < d // 2).float()
                faults[case] = planted(case, xs, ws, ref, tol, half, d // 2)
            if plan.path == "vector":
                # The row past the 8 vectors a lane keeps in registers left
                # out of the sum.
                case = f"the sum of x^2 over the registers' share of each row only, {name}"
                faults[case] = planted(case, xs, ws, ref, tol, (vec < 8 * 32).float(), d)
            if shape == (2640, 8192):
                # A group of several warps that leaves out the others' partial
                # sums: each row's statistics from the vectors its first warp
                # holds.
                case = (f"statistics from the first of {plan.warps_per_row} warps a row only, "
                        f"{name} ({plan.path})")
                first = (vec % (32 * plan.warps_per_row) < 32).float()
                faults[case] = planted(case, xs, ws, ref, tol, first, first.sum())
            del xs, ws, ref
    note("rms_norm", planted=faults)

    # Backward: the closed form after the kernel's forward, against
    # autograd through the plain version.
    x, w = inputs((n, e), torch.bfloat16)
    g = torch.randn(n, e, generator=gen, device=dev).to(torch.bfloat16)
    grads = []
    for fn in (R.rms_norm_pallas, R._rms_reference):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        fn(xg, wg, eps).backward(g)
        grads.append((xg.grad, wg.grad))
    (dx, dw), (rdx, rdw) = grads
    check("rms_norm_pallas backward dx", dx, rdx, TOL_RMS_GRAD)
    check("rms_norm_pallas backward dw", dw, rdw, TOL_RMS_GRAD)
    torch.cuda.synchronize()


def rms_times(gen, n: int, e: int) -> dict:
    """K6's times at four shapes, x [n, e] (the flagship's) and RMS_LARGE,
    each in bf16 and f32 with w f32.  Inputs rotate through at least twice
    the 50 MB L2, so each call reads x from device memory, as a caller with
    a fresh activation would, and the last ``copies`` outputs are held, so
    the outputs rotate through as many buffers.  Per shape: ``device_ms``
    (``graph_ms`` of the wrapper: the kernel apart from its host work),
    ``ms`` (eager: the wrapper called from Python back to back, the kernels
    line's ``ms`` as before), ``host_ms`` (``host_ms`` of the wrapper: the
    host's share of a call),
    ``library_ms`` (``F.rms_norm`` with w f32, the same function; eager and
    ``library_device_ms``), ``library_bf16w_ms`` (w cast to bf16, the pair
    PyTorch fuses: a reference point only) and the bound (bytes: x read,
    out written, w read, once each).  Returns the flagship bf16 shape's
    numbers, with the plain version's time there, and all four under
    ``shapes``."""
    import torch
    import torch.nn.functional as F

    from torchft_tpu_torch.ops import rmsnorm as R

    dev = torch.device("cuda")
    sms = R._sms(dev)
    shapes = {}
    top = {}
    for rows, d in ((n, e), RMS_LARGE):
        for dtype in (torch.bfloat16, torch.float32):
            nbytes = rows * d * dtype.itemsize
            copies = max(2, -(-2 * L2_BYTES // nbytes))
            xs = [torch.randn(rows, d, generator=gen, device=dev).to(dtype) for _ in range(copies)]
            wr = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
            wr_bf16 = wr.to(torch.bfloat16)
            turn = itertools.count()
            held = collections.deque(maxlen=copies)

            def rotating(fn):
                return lambda: held.append(fn(xs[next(turn) % copies]))

            plan = R.rms_plan(rows, d, dtype, sms)
            name = f"x [{rows}, {d}] {str(dtype).split('.')[-1]}"
            r = {
                "path": plan.path, "plan": plan._asdict(),
                "device_ms": graph_ms(rotating(lambda x: R.rms_fwd(x, wr, 1e-6)), RMS_GRAPH_REPS),
                "ms": cuda_ms(rotating(lambda x: R.rms_fwd(x, wr, 1e-6)), 100),
                "host_ms": host_ms(rotating(lambda x: R.rms_fwd(x, wr, 1e-6))),
                "library_ms": cuda_ms(rotating(lambda x: F.rms_norm(x, (d,), wr, 1e-6)), 100),
                "library_device_ms": graph_ms(rotating(lambda x: F.rms_norm(x, (d,), wr, 1e-6)),
                                              RMS_GRAPH_REPS),
                "library_bf16w_ms": cuda_ms(
                    rotating(lambda x: F.rms_norm(x, (d,), wr_bf16, 1e-6)), 100),
                # ~4 f32 operations an element take far less than the bytes'
                # time: the bound is the bytes.
                **bound(0.0, 2 * nbytes + d * 4),
            }
            r["device_share_of_bound"] = r["bound_ms"] / r["device_ms"]
            print(f"  rms_norm {name} ({plan.path}, R {plan.rows_per_tile}, {plan.stages} "
                  f"stages, {plan.blocks} blocks): device {r['device_ms']:.4f} ms, eager "
                  f"{r['ms']:.4f} ms, host {r['host_ms']:.4f} ms a call, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
                  f"{r['device_share_of_bound']:.0%} of it on the device); F.rms_norm w f32 "
                  f"{r['library_ms']:.4f} ms (device {r['library_device_ms']:.4f}), w bf16 "
                  f"{r['library_bf16w_ms']:.4f} ms", flush=True)
            shapes[name] = r
            if not top:
                lib_dtype = F.rms_norm(xs[0], (d,), wr, 1e-6).dtype
                top = {k: r[k] for k in ("device_ms", "ms", "host_ms", "library_ms",
                                         "library_bf16w_ms", "bound_ms", "bound_by", "flops",
                                         "bytes")}
                top["plain_ms"] = cuda_ms(rotating(lambda x: R._rms_reference(x, wr, 1e-6)), 20)
                top["library_call"] = (f"F.rms_norm(x bf16, ({d},), w f32, 1e-6), which returns "
                                       f"{lib_dtype}")
            del xs, held
            torch.cuda.empty_cache()
    return {**top, "shapes": shapes}


# -- phase 4: the RMSNorm entry point ------------------------------------------


def rms_entry_point() -> dict:
    """``rms_norm_pallas`` forward and backward through autograd on flagship
    activations, counts set to 0 just before and read just after."""
    import torch

    from torchft_tpu_torch.models import flagship_config
    from torchft_tpu_torch.ops import launch_counts, reset_launch_counts, rms_norm_pallas

    cfg, batch, seq = flagship_config()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(batch, seq, cfg.d_model, generator=gen, device=dev).to(torch.bfloat16)
    w = torch.ones(cfg.d_model, device=dev, requires_grad=True)
    reset_launch_counts()
    for _ in range(RMS_CALLS):
        xg = x.clone().requires_grad_()
        out = rms_norm_pallas(xg, w)
        out.float().square().mean().backward()
        if not (torch.isfinite(xg.grad).all() and torch.isfinite(w.grad).all()):
            raise AssertionError("rms_norm_pallas: non-finite gradients")
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {name: (RMS_CALLS if name == "rms_norm" else 0) for name in counts}
    if counts != want:
        raise AssertionError(f"rms_norm_pallas phase launched {counts}, expected {want}")
    print(f"  rms_norm_pallas x [{batch}, {seq}, {cfg.d_model}] bf16: {RMS_CALLS} forward + "
          f"backward calls, launches {counts['rms_norm']}", flush=True)
    return counts


# -- phase 5: one replica group (run as its own process) ---------------------

# The worker /metrics endpoint of every flagship group: any free port, on
# IPv4 loopback (the default bind is ::1, which a host may lack).
WORKER_METRICS_ENV = {"TPUFT_WORKER_METRICS_PORT": "0", "TPUFT_WORKER_METRICS_BIND": "127.0.0.1"}
COUNTER_SUFFIXES = ("_total", "_count", "_sum", "_bucket")


def worker_scrape(manager, prev: dict = None, check_lanes: bool = True) -> dict:
    """One HTTP scrape of the group's worker ``/metrics`` (the Manager's
    endpoint; it must be serving), held against the ring's ``lane_totals()``
    read just after it (with ``check_lanes``, where no ring op can run
    between the two: the step is over), and against ``prev``, the last
    scrape of the same endpoint: no counter or histogram series falls.  Returns the samples, the text's bytes and
    lines, the scrape's ms and the hop histograms' summed ``_count``."""
    import urllib.request

    wm = manager.worker_metrics
    if not wm.serving:
        raise AssertionError(f"{manager.replica_id()}: the worker /metrics endpoint is not "
                             f"serving")
    t0 = time.perf_counter()
    with urllib.request.urlopen(f"http://127.0.0.1:{wm.port}/metrics", timeout=30) as resp:
        text = resp.read().decode()
    ms = (time.perf_counter() - t0) * 1e3
    samples = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            samples[key] = float(value)
    lt = manager.collective().lane_totals() if check_lanes else {"tiers": {}}
    rid = manager.replica_id()
    for tier, t in lt["tiers"].items():
        lab = f'{{replica="{rid}",tier="{tier}"}}'
        got = tuple(samples.get(f"{name}{lab}") for name in (
            "tpuft_worker_lane_sent_bytes_total", "tpuft_worker_lane_recv_bytes_total",
            "tpuft_worker_hops_total"))
        want = (t["sent_bytes"], t["recv_bytes"], lt["hops"][tier]["hops"])
        if got != want:
            raise AssertionError(f"{rid}: the scrape's lane totals of tier {tier} {got} are not "
                                 f"the ring's lane_totals {want}")
    for key, v in (prev or {}).get("samples", {}).items():
        if key.split("{")[0].endswith(COUNTER_SUFFIXES) and samples.get(key, -1.0) < v:
            raise AssertionError(f"{rid}: {key} fell from {v} to {samples.get(key)}")
    hop_count = sum(v for k, v in samples.items()
                    if k.startswith("tpuft_worker_hop_latency_seconds_count"))
    return {"samples": samples, "bytes": len(text.encode()), "lines": len(text.splitlines()),
            "ms": ms, "hop_count": hop_count, "port": wm.port}


def run_group(args: argparse.Namespace) -> None:
    import logging
    from datetime import timedelta

    import torch

    from torchft_tpu_torch.checkpointing import HTTPTransport
    from torchft_tpu_torch.collectives import TCPCollective
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.models import Transformer, flagship_config, loss_fn, resolve_device
    from torchft_tpu_torch.ops import launch_counts, reset_launch_counts
    from torchft_tpu_torch.parallel import TrainStep

    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format=f"[g{args.group}] %(message)s")
    group, run_dir = args.group, args.run_dir
    cfg, batch, seq = flagship_config()
    dev = resolve_device("cuda")
    model = Transformer(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1000 + group))
    # Every AdamW hyperparameter explicit (the JAX side's optax defaults differ).
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)

    def state_dict():
        return {"model": model.state_dict(), "optim": opt.state_dict()}

    def load_state_dict(sd):
        model.load_state_dict(sd["model"])
        opt.load_state_dict(sd["optim"])

    def wait_for(path: str) -> None:
        deadline = time.monotonic() + GROUP_TIMEOUT_S
        while not os.path.exists(path):
            if time.monotonic() > deadline:
                raise TimeoutError(f"group {group}: {path} never appeared")
            time.sleep(0.05)

    timeout = timedelta(seconds=180)
    collective = TCPCollective(timeout=180.0, host="127.0.0.1")
    transport = HTTPTransport(timeout=180.0, host="127.0.0.1")
    manager = Manager(
        collective=collective,
        load_state_dict=load_state_dict,
        state_dict=state_dict,
        min_replica_size=1,
        rank=0,
        world_size=1,
        replica_id=f"smoke_g{group}",
        lighthouse_addr=args.lighthouse,
        store_addr="127.0.0.1",
        manager_bind="127.0.0.1:0",
        checkpoint_transport=transport,
        timeout=timeout,
        quorum_timeout=timeout,
    )
    trainer = TrainStep(model, opt, loss_fn, manager)
    data = torch.Generator(device=dev).manual_seed(7 + group)
    if not manager.worker_metrics.serving:
        raise AssertionError(f"group {group}: the worker /metrics endpoint is not serving")
    print(f"WORKER_METRICS group {group} port {manager.worker_metrics.port}", flush=True)

    reset_launch_counts()
    steps, merged, healed = [], 0, 0
    ring_seen: dict = {}
    scrapes: list = []
    while merged < MERGED_STEPS:
        if len(steps) > 100:
            raise RuntimeError("group never merged with its peer")
        before = manager.current_step()
        manager.start_quorum()
        if group == 1 and not steps:
            # This request waits at the lighthouse (1 of 2 healthy groups
            # joined) until group 0 joins too, so group 1 joins at step
            # SOLO_STEPS + 1 in every run: two runs of one tree take the same
            # steps and end with the same params_sha256.
            time.sleep(JOIN_GRACE_S)
            open(os.path.join(run_dir, "g1_up"), "w").close()
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=data, device=dev)
        b = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}
        t0 = time.perf_counter()
        loss, committed = trainer.ft_step(b)
        loss_v = float(loss)  # waits for the step's kernels
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        participants = manager.num_participants()
        jumped = manager.current_step() - before > 1
        healed += int(jumped)
        rec = {"group": group, "step": manager.current_step(), "loss": loss_v,
               "committed": committed, "participants": participants,
               "ring": collective.size(), "healed": jumped, "step_s": dt,
               "speculated": trainer.last_speculation is not None}
        if collective.size() == 2:
            # The averager's last exchange: this step's (alone it returns
            # before any copy and keeps the previous step's stats), under
            # the step its spans carry.
            rec["exchange"] = dict(trainer.averager.last_stats)
            rec["span_step"] = before
            ring_seen = {"ring_engine": collective.ring_engine, "lanes": collective.lanes,
                         "wire": collective.wire_dtype,
                         "transport": collective.ring_transport}
        steps.append(rec)
        print("STEP " + json.dumps(rec), flush=True)
        # Scrapes: at the first step on the two-group ring (group 1's heal
        # step) and after the last merged step.
        if collective.size() == 2 and (not scrapes or merged + (participants == 2)
                                       == MERGED_STEPS):
            sc = worker_scrape(manager, scrapes[-1] if scrapes else None)
            sc["step"] = manager.current_step()
            scrapes.append(sc)
        if not committed:
            raise RuntimeError(f"group {group}: step {before} did not commit")
        if not math.isfinite(loss_v):
            raise RuntimeError(f"group {group}: loss {loss_v} is not finite")
        if participants == 2:
            merged += 1
        if group == 0 and manager.current_step() == SOLO_STEPS:
            open(os.path.join(run_dir, "g0_ready"), "w").close()
            wait_for(os.path.join(run_dir, "g1_up"))

    counts = launch_counts()
    # The ring's sampled hop timeline, for the trace and the data-plane
    # rollup of the stream.
    with open(os.path.join(run_dir, f"hops_g{group}.json"), "w") as f:
        json.dump({"replica_id": f"smoke_g{group}", "records": collective.hop_records(),
                   "lane_totals": collective.lane_totals()}, f)
    h = hashlib.sha256()
    for name, p in model.state_dict().items():
        h.update(name.encode())
        h.update(p.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    merged_recs = [r for r in steps if r["participants"] == 2]
    merged_s = [r["step_s"] for r in merged_recs]
    # Group 0's solo steps (ring of one: no gradient traffic), the first
    # one (warm-up) left out.
    solo_s = [r["step_s"] for r in steps[1:] if r["ring"] == 1]
    n_params = sum(p.numel() for p in model.parameters())
    tokens = batch * seq
    result = {
        "group": group,
        **ring_seen,
        "exchange_last_stats": merged_recs[-1]["exchange"],
        # Each merged step's waits, keyed by the step its spans carry.
        "exchange_by_step": {str(r["span_step"]): r["exchange"] for r in merged_recs},
        # Mean over the merged steps of the train thread's waits in the
        # averager: for the copies off the card, for the ring, for the
        # copies back.
        "merged_split_ms": {
            k: 1e3 * sum(r["exchange"][k] for r in merged_recs) / len(merged_recs)
            for k in ("d2h_wait_s", "ring_wait_s", "h2d_s")
        },
        "steps_run": len(steps),
        "final_step": manager.current_step(),
        "healed": healed,
        "launches": counts,
        "losses": [r["loss"] for r in steps],
        "params_sha256": h.hexdigest(),
        "heal_step_ms": [1e3 * r["step_s"] for r in steps if r["ring"] == 2
                         and r["participants"] == 1],
        "merged_step_ms": 1e3 * sum(merged_s) / len(merged_s),
        "tokens_per_s": tokens * len(merged_s) / sum(merged_s),
        "solo_step_ms": 1e3 * sum(solo_s) / len(solo_s) if solo_s else None,
        # 6 N per token for the dense layers plus the causal attention term
        # 6 L S d (the JAX bench's model-FLOP count).
        "model_flops_per_step": (6 * n_params + 6 * cfg.n_layers * seq * cfg.d_model) * tokens,
    }
    # The donor's snapshot, flattened on the transport's background thread,
    # and the healer's fetch.
    transport.wait_snapshot(timeout=GROUP_TIMEOUT_S)
    result["snapshot"] = dict(transport.last_snapshot)
    result["fetch"] = dict(transport.last_fetch)
    result["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    result["worker_scrapes"] = [{k: v for k, v in sc.items() if k != "samples"}
                                for sc in scrapes]
    # overlap_commit=None, resolved after the first committed step.
    result["overlap_decision"] = trainer.overlap_decision
    result["speculated_steps"] = sum(r["speculated"] for r in steps)
    manager.shutdown()
    if group == 0:
        # The compute alone: TrainStep.full_step (forward, backward, AdamW;
        # no quorum, no cross-group average), timed after the FT run.
        raw = []
        for _ in range(RAW_STEPS):
            t0 = time.perf_counter()
            float(trainer.full_step(b))
            torch.cuda.synchronize()
            raw.append(time.perf_counter() - t0)
        result["raw_step_ms"] = 1e3 * sum(raw) / len(raw)
    print("RESULT " + json.dumps(result), flush=True)


# -- phase 5: the parent process -----------------------------------------------


def main_path(card: str, transport: str = "tcp") -> tuple:
    """Phase 5 with both groups' rings on ``transport`` (the port's
    ``TPUFT_RING_TRANSPORT``): returns the K1-K5 launches of both groups,
    the streams' tables, and group 0's results."""
    from torchft_tpu_torch._native import LighthouseServer

    lighthouse = LighthouseServer(bind="127.0.0.1:0", http_bind="127.0.0.1:0",
                                  min_replicas=1, join_timeout_ms=100)
    run_dir = tempfile.mkdtemp(prefix="tpuft_smoke_")
    procs, readers, results, errors = {}, {}, {}, []

    def start(group: int) -> None:
        env = {**os.environ, "TPUFT_METRICS_PATH": os.path.join(run_dir, f"metrics_g{group}.jsonl"),
               "TPUFT_RING_TRANSPORT": transport, **WORKER_METRICS_ENV}
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--group", str(group),
             "--lighthouse", lighthouse.address(), "--run-dir", run_dir],
            stdout=subprocess.PIPE, text=True, cwd=HERE, env=env,
        )
        procs[group] = proc

        def read() -> None:
            assert proc.stdout is not None
            for line in proc.stdout:
                line = line.rstrip("\n")
                print(f"  [g{group}] {line}", flush=True)
                if line.startswith("RESULT "):
                    results[group] = json.loads(line[len("RESULT "):])

        readers[group] = threading.Thread(target=read, daemon=True)
        readers[group].start()

    def poll_failures() -> None:
        for g, p in procs.items():
            rc = p.poll()
            if rc not in (None, 0):
                errors.append(f"group {g} exited with {rc}")
        if errors:
            raise RuntimeError("; ".join(errors))

    try:
        t_start = time.monotonic()
        start(0)
        while not os.path.exists(os.path.join(run_dir, "g0_ready")):
            poll_failures()
            if time.monotonic() - t_start > GROUP_TIMEOUT_S:
                raise TimeoutError("group 0 never committed its solo steps")
            time.sleep(0.1)
        start(1)
        for g, p in procs.items():
            rc = p.wait(timeout=GROUP_TIMEOUT_S)
            readers[g].join(timeout=30)
            if rc != 0:
                raise RuntimeError(f"group {g} exited with {rc}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        lighthouse.shutdown()
    try:
        stream = stream_phase(run_dir, results, card)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)

    r0, r1 = results[0], results[1]
    if r0["final_step"] != r1["final_step"]:
        raise AssertionError(f"final steps differ: {r0['final_step']} vs {r1['final_step']}")
    if r1["healed"] != 1 or r0["healed"] != 0:
        raise AssertionError(f"expected group 1 to heal once: {r0['healed']}, {r1['healed']}")
    if r0["params_sha256"] != r1["params_sha256"]:
        raise AssertionError("the groups' final parameters differ")
    for r in (r0, r1):
        ring = (r.get("ring_engine"), r.get("lanes"), r.get("wire"), r.get("transport"))
        print(f"group {r['group']}: ring engine {ring[0]}, {ring[1]} lanes, {ring[2]} wire, "
              f"{ring[3]} lanes' transport; averager last_stats "
              f"{json.dumps(r['exchange_last_stats'])}", flush=True)
        if ring != ("native", 2, "f32", transport):
            raise AssertionError(f"group {r['group']} ran the ring {ring}, expected the "
                                 f"defaults ('native', 2, 'f32') on {transport!r}")
    # The donor's snapshot runs on the transport's background thread; the
    # train thread waits only for the device copy to be queued.
    snap = r0["snapshot"]
    rows = stream["steps"][0]
    snap_ms = sum(row["snapshot"] for row in rows)
    wait_ms = sum(row["snapshot_wait"] for row in rows)
    print(f"group 0 (donor): snapshot {snap_ms:.1f} ms of {snap.get('bytes', 0) / 1e9:.3f} GB "
          f"on thread {snap.get('thread')!r} (step {snap.get('step')}); the train thread's "
          f"snapshot_wait {wait_ms:.3f} ms ({card})", flush=True)
    if snap.get("thread") != "tpuft_torch_http_snapshot":
        raise AssertionError(f"the donor's snapshot ran on {snap.get('thread')!r}, not the "
                             f"background snapshotter")
    if not (snap_ms > 0 and wait_ms < 0.1 * snap_ms):
        raise AssertionError(f"snapshot_wait {wait_ms:.3f} ms is not under 10% of the "
                             f"snapshot span {snap_ms:.3f} ms")
    # The healer's fetch: one donor, chunked in parallel on a host with the
    # cores (the receiver's choice), every buffer checksum-verified.
    fetch = r1["fetch"]
    n_bufs = fetch.get("crc_verified")
    print(f"group 1 (healer): {fetch.get('mode')} fetch of {fetch.get('bytes', 0) / 1e9:.3f} GB "
          f"from {fetch.get('n_donors')} donor in {fetch.get('fetch_s')} s = "
          f"{fetch.get('bytes', 0) / 1e9 / max(fetch.get('fetch_s') or 1e-9, 1e-9):.3f} GB/s; "
          f"{fetch.get('n_stripes')} stripes over {fetch.get('workers')} workers; "
          f"{n_bufs} buffers checksum-verified in {fetch.get('crc_ms')} ms; the donor stamped "
          f"them in {snap.get('crc_ms')} ms; peak device memory {r0['peak_mem_bytes'] / 2**30:.2f}"
          f" / {r1['peak_mem_bytes'] / 2**30:.2f} GiB ({card})", flush=True)
    if (os.cpu_count() or 1) >= 2 and (fetch.get("mode") != "chunked" or fetch.get("workers", 0) < 2
                                       or not n_bufs):
        raise AssertionError(f"the single-donor heal on a {os.cpu_count()}-core host was not a "
                             f"checksummed chunked fetch: {fetch}")
    for r in (r0, r1):
        sc = r["worker_scrapes"]
        if len(sc) != 2 or sc[-1]["hop_count"] <= 0:
            raise AssertionError(f"group {r['group']}: worker /metrics scrapes {sc}: expected one "
                                 f"after the heal step and one after the last merged step, with "
                                 f"hop histogram counts")
        print(f"group {r['group']} worker /metrics (port {sc[0]['port']}): scrapes at steps "
              f"{[x['step'] for x in sc]}, "
              + ", ".join(f"{x['bytes']} bytes / {x['lines']} lines in {x['ms']:.2f} ms"
                          for x in sc)
              + f"; hop latency counts {[x['hop_count'] for x in sc]}; counters monotonic, lane "
              f"totals equal to lane_totals() ({card})", flush=True)
    for r in (r0, r1):
        d = r["overlap_decision"]
        if d is None:
            raise AssertionError(f"group {r['group']}: overlap_commit was never resolved")
        mem = (f"free {d['free'] / 2**30:.3f} GiB of {d['total'] / 2**30:.3f}, this process's "
               f"limit {d['limit'] / 2**30:.3f} GiB, allocator peak "
               f"{d['high_water'] / 2**30:.3f} GiB" if d.get("free") is not None
               else "no memory statistics")
        print(f"group {r['group']}: overlap_commit resolved {d['overlap']} "
              f"({'the speculative step' if d['overlap'] else 'the SERIAL step'}) after its "
              f"first committed step: extra {d['extra_bytes'] / 2**30:.3f} GiB for the copy; "
              f"{mem}; {r['speculated_steps']} of {r['steps_run']} steps speculated ({card})",
              flush=True)
    same = r0["params_sha256"] == PREVIOUS_PARAMS_SHA256
    print(f"params_sha256 {r0['params_sha256']}; previous tree's {PREVIOUS_PARAMS_SHA256}: "
          f"{'equal' if same else 'DIFFERENT'}", flush=True)
    if not same:
        raise AssertionError("phase 5 ended with other parameters than the previous tree's "
                             "(the speculative step changes nothing in the arithmetic)")
    from torchft_tpu_torch.models import flagship_config

    cfg, batch, seq = flagship_config()
    per_step = {"flash_fwd": cfg.n_layers, "flash_bwd_dkdv": cfg.n_layers,
                "flash_bwd_dq": cfg.n_layers, "ce_lse": 1, "ce_dlogits": 1}
    for r in (r0, r1):
        for name, k in per_step.items():
            want = k * r["steps_run"]
            if r["launches"].get(name) != want:
                raise AssertionError(
                    f"group {r['group']}: {name} launched {r['launches'].get(name)} times, "
                    f"expected {want} ({k} x {r['steps_run']} steps)"
                )
    for r in (r0, r1):
        print(f"group {r['group']}: {r['steps_run']} steps to step {r['final_step']}, "
              f"merged step {r['merged_step_ms']:.1f} ms, {r['tokens_per_s']:.0f} tokens/s, "
              f"heal step {r['heal_step_ms']} ms ({card}); params_sha256 {r['params_sha256']}",
              flush=True)
    flops = r0["model_flops_per_step"]
    tokens = batch * seq
    for name, ms in (("raw full_step", r0["raw_step_ms"]), ("solo ft_step", r0["solo_step_ms"]),
                     ("merged ft_step", r0["merged_step_ms"])):
        print(f"group 0 {name}: {ms:.1f} ms, {tokens / ms * 1e3:.0f} tokens/s, "
              f"{flops / ms / 1e9:.1f} model TFLOP/s = "
              f"{flops / ms * 1e3 / PEAK_BF16_FLOPS:.4f} of the bf16 peak ({card})", flush=True)
    for r in (r0, r1):
        split = r["merged_split_ms"]
        print(f"group {r['group']} merged ft_step {r['merged_step_ms']:.1f} ms, of which the train "
              f"thread waited {split['d2h_wait_s']:.1f} ms for the copies off the card, "
              f"{split['ring_wait_s']:.1f} ms for the ring, {split['h2d_s']:.1f} ms for the "
              f"copies back (mean of {MERGED_STEPS} merged steps; ring lanes on {transport}; "
              f"{card})", flush=True)
    return ({name: r0["launches"][name] + r1["launches"][name] for name in per_step}, stream,
            r0)


def stream_phase(run_dir: str, results: dict, card: str) -> dict:
    """Phase 5's metrics streams, read by the port's own consumers: every
    committed step has a step_summary, the heal a ``heal`` span, the donor
    a ``snapshot`` span; each merged step's averager spans sum to its
    ``last_stats`` waits within SPAN_TOL_MS; the merged trace validates;
    then the per-step phase table of each group, ``obs.report.attribute``
    per group, and the data-plane rollups of the stream and of the hops."""
    from torchft_tpu_torch.obs import report, trace

    paths = {g: os.path.join(run_dir, f"metrics_g{g}.jsonl") for g in (0, 1)}
    by_group = {g: report.read_events([p]) for g, p in paths.items()}
    events = report.read_events(list(paths.values()))
    hop_events = []
    for g in (0, 1):
        with open(os.path.join(run_dir, f"hops_g{g}.json")) as f:
            dump = json.load(f)
        hop_events += trace.hops_to_stream(dump)
        totals = dump["lane_totals"]["hops"].get("flat", {})
        print(f"  group {g}: {len(dump['records'])} sampled hops kept; lane_totals "
              f"{json.dumps(dump['lane_totals'])}", flush=True)
        if not dump["records"] or not totals.get("hops"):
            raise AssertionError(f"group {g}: the ring recorded no hops")
    for g, evs in by_group.items():
        commits = sorted(e["step"] for e in evs if e["event"] == "commit" and e["committed"])
        summaries = sorted(e["step"] for e in evs
                           if e["event"] == "step_summary" and e["committed"])
        if commits != summaries or len(commits) != results[g]["steps_run"]:
            raise AssertionError(f"group {g}: committed steps {commits} but step_summary "
                                 f"for {summaries} ({results[g]['steps_run']} steps run)")
        phases = {e["phase"] for e in evs if e["event"] == "span"}
        want = {"quorum", "allreduce_d2h", "allreduce_merge", "allreduce_h2d", "commit_vote",
                "heal" if g == 1 else "snapshot"}
        if not want <= phases:
            raise AssertionError(f"group {g}: spans {sorted(phases)} lack {sorted(want - phases)}")
        for step, st in results[g]["exchange_by_step"].items():
            got = {k: 0.0 for k in ("allreduce_d2h", "allreduce_merge", "allreduce_h2d")}
            for e in evs:
                if e["event"] == "span" and e["step"] == int(step) and e["phase"] in got:
                    got[e["phase"]] += e["duration_ms"]
            stats = {"allreduce_d2h": st["d2h_wait_s"], "allreduce_merge": st["ring_wait_s"],
                     "allreduce_h2d": st["h2d_s"]}
            diff = {k: got[k] - 1e3 * stats[k] for k in got}
            print(f"  group {g} step {step}: spans d2h / merge / h2d "
                  f"{got['allreduce_d2h']:.3f} / {got['allreduce_merge']:.3f} / "
                  f"{got['allreduce_h2d']:.3f} ms, last_stats "
                  f"{1e3 * stats['allreduce_d2h']:.3f} / {1e3 * stats['allreduce_merge']:.3f} / "
                  f"{1e3 * stats['allreduce_h2d']:.3f} ms", flush=True)
            if any(abs(d) > SPAN_TOL_MS for d in diff.values()):
                raise AssertionError(f"group {g} step {step}: span sums differ from last_stats "
                                     f"by {diff} ms (> {SPAN_TOL_MS})")
    problems = trace.validate_trace(trace.build_trace(sorted(events + hop_events,
                                                             key=lambda e: e["ts"])))
    if problems:
        raise AssertionError(f"the merged trace does not validate: {problems}")
    print(f"  trace of {len(events)} records + {len(hop_events)} hops: validates clean",
          flush=True)
    cols = ("quorum", "heal", "allreduce_d2h", "allreduce_merge", "allreduce_h2d",
            "commit_vote", "snapshot", "snapshot_wait")
    table = {}
    for g, evs in by_group.items():
        print(f"  group {g} per step, ms ({card}): step, wall, busy, " + ", ".join(cols),
              flush=True)
        rows = []
        for e in evs:
            if e["event"] != "step_summary":
                continue
            ph = e["phases"]
            row = {"step": e["step"], "committed": e["committed"],
                   "wall": e.get("step_wall_ms"), "busy": e.get("step_time_ms"),
                   **{c: ph.get(c, 0.0) for c in cols}}
            rows.append(row)
            print("    " + "  ".join(str(row[k]) for k in ("step", "wall", "busy", *cols)),
                  flush=True)
        table[g] = rows
        attribution = report.attribute(evs)
        print(f"  group {g}: obs.report.attribute", flush=True)
        report.render(attribution)
    plane = report.data_plane(events)
    links = report.link_attribution(events)
    print(f"  data_plane {json.dumps(plane)}", flush=True)
    print(f"  link_attribution (hop stall split) {json.dumps(links)}", flush=True)
    return {"steps": table, "data_plane": plane, "link_attribution": links}


# -- phase 6: kill and heal ---------------------------------------------------


def _ms(x) -> str:
    """A mean step time; None where the window held under two steps."""
    return "n/a (under two steps)" if x is None else f"{x:.2f} ms"


def kill_heal_phase(card: str) -> dict:
    from torchft_tpu_torch.examples.kill_heal import LOG_POLL_S, kill_and_heal

    # The floor of a restart: a bare process importing torch and reaching
    # the card.
    t0 = time.monotonic()
    subprocess.run([sys.executable, "-c", "import torch; torch.zeros(1, device='cuda')"],
                   check=True, timeout=300)
    cold_start_s = time.monotonic() - t0
    from torchft_tpu_torch.obs import report

    log_dir = tempfile.mkdtemp(prefix="tpuft_kill_")
    try:
        r = kill_and_heal("cuda", log_dir, steps=KILL_STEPS, merged_before_kill=KILL_MERGED,
                          timeout_s=KILL_TIMEOUT_S)
        events = report.read_events([r["metrics_path"]])
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    faults = report.fault_times(events)
    if [g for _, g in faults] != ["1"]:
        raise AssertionError(f"the stream's fault records name {faults}, expected one kill of 1")
    commits = report.commit_timelines(events)
    dw = report.deadwindow(commits, faults)
    if not dw["victims_recovered"] or dw["dead_time_s"] is None:
        raise AssertionError(f"the stream's dead window did not close: {dw}")
    # The stream's dead time is group 1's commit gap over the kill less one
    # median step; recovery_s ends at its first MERGED commit as a 20 ms log
    # poll reads it.  The gap starts at the last commit before the kill and
    # ends at the first commit after it (the heal step's).
    t_fault = faults[0][0]
    steps = sorted(commits["1"])
    k = next(i for i, t in enumerate(steps) if t > t_fault)
    merged = min(float(e["ts"]) for e in events
                 if e["event"] == "commit" and e["committed"] and e["participants"] == 2
                 and str(e["replica_id"]).startswith("1:") and float(e["ts"]) > t_fault)
    r["stream_dead_time_s"] = dw["dead_time_s"]
    r["stream_gap_s"] = steps[k] - steps[k - 1]
    r["stream_fault_to_first_commit_s"] = steps[k] - t_fault
    r["stream_fault_to_first_merged_commit_s"] = merged - t_fault
    print(f"  stream: fault record at the kill; obs.report.deadwindow dead time "
          f"{dw['dead_time_s']:.3f} s (group 1's commit gap {r['stream_gap_s']:.3f} s less a "
          f"median step; dead-window goodput fraction {dw['fraction']}) beside recovery_s "
          f"{r['recovery_s']:.3f} s: {dw['dead_time_s'] - r['recovery_s']:+.3f} s; fault -> "
          f"group 1's first commit {r['stream_fault_to_first_commit_s']:.3f} s, first merged "
          f"commit {merged - t_fault:.3f} s ({merged - t_fault - r['recovery_s']:+.3f} s "
          f"against recovery_s, which a {1e3 * LOG_POLL_S:.0f} ms log poll stamps) ({card})",
          flush=True)
    print(f"  restarts {r['restarts']}; both groups FINAL at step {r['final_step']} with "
          f"params_sha256 {r['params_sha256']}; {r['steps_logged']} finite losses", flush=True)
    print(f"  kill -> restarted group's first merged commit: {r['recovery_s']:.3f} s "
          f"(kill -> respawn {r['kill_to_restart_s']:.3f} s, -> heal line "
          f"{r['kill_to_heal_line_s']:.3f} s); survivor uncommitted steps "
          f"{r['survivor_uncommitted_steps']}; survivor step "
          f"{_ms(r['survivor_solo_step_ms'])} alone, {_ms(r['survivor_merged_step_ms'])} "
          f"merged ({card})", flush=True)
    print(f"  a bare process importing torch and reaching the card: {cold_start_s:.3f} s "
          f"({card})", flush=True)
    r["cold_start_s"] = cold_start_s
    print("KILL_HEAL " + json.dumps(r), flush=True)
    return r


RESUME_STEPS = 20          # train_ddp's --steps in the first job of the disk resume
RESUME_EVERY = 10         # its --ckpt_every


def resume_phase(card: str) -> dict:
    """Phase 6's disk resume: the train_ddp example's two groups under the
    Launcher with ``--ckpt_dir`` run to RESUME_STEPS and stop; a second job
    resumes both from disk ("resumed from disk checkpoint step=...") and
    runs on to twice the steps, both groups ending with one
    params_sha256."""
    from torchft_tpu_torch.examples.kill_heal import stop_and_resume

    log_dir = tempfile.mkdtemp(prefix="tpuft_resume_")
    try:
        r = stop_and_resume("cuda", log_dir, steps=RESUME_STEPS, ckpt_every=RESUME_EVERY,
                            timeout_s=KILL_TIMEOUT_S)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    print(f"  first job: both groups FINAL at step {r['first']['final_step']} in "
          f"{r['first']['seconds']:.3f} s; second job: both 'resumed from disk checkpoint "
          f"step={r['resumed_step']}', FINAL at step {r['resumed']['final_step']} with "
          f"params_sha256 {r['resumed']['params_sha256'][:16]}… in "
          f"{r['resumed']['seconds']:.3f} s ({card})", flush=True)
    return r


# -- phase 7: the bare ring ---------------------------------------------------

# (engine, lanes, wire, codec, transport): the earlier port's ring, then the
# defaults, then the bf16 wire, then the int8 and int4 wire codecs on 2
# lanes, each on the Python engine and the native one; then the transport
# axis: shm lanes on both engines, 2 lanes, on the f32 and bf16 wires and
# under int8, each held bit for bit against its TCP twin above.
BARE_RING_CONFIGS = (("py", 1, "f32", None, "tcp"), ("native", 2, "f32", None, "tcp"),
                     ("native", 2, "bf16", None, "tcp"), ("py", 2, "bf16", None, "tcp"),
                     ("py", 2, "f32", "int8", "tcp"), ("native", 2, "f32", "int8", "tcp"),
                     ("py", 2, "f32", "int4", "tcp"), ("native", 2, "f32", "int4", "tcp"),
                     ("py", 2, "f32", None, "shm"), ("native", 2, "f32", None, "shm"),
                     ("py", 2, "bf16", None, "shm"), ("native", 2, "bf16", None, "shm"),
                     ("py", 2, "f32", "int8", "shm"), ("native", 2, "f32", "int8", "shm"))
# The shaped link of phase 7: each direction paced at SHAPED_MBPS with
# SHAPED_RTT_MS (set_link_shaping, after an unshaped configure).
SHAPED_MBPS = 8000.0
SHAPED_RTT_MS = 1.0
# ring2d's sum of 4 addends is reassociated: within (addends - 1) roundings
# of the exact sum, each at most 2^-24 of the sum of magnitudes.
RING2D_RANKS = 4


def flagship_param_count(cfg=None) -> int:
    """Parameters of the flagship transformer (or of ``cfg``, a cut of it):
    its gradient payload in float32 elements."""
    from torchft_tpu_torch.models import flagship_config

    cfg = cfg or flagship_config()[0]
    E, V, F, Dh = cfg.d_model, cfg.vocab_size, cfg.d_ff, cfg.d_head
    layer = 2 * E + E * cfg.n_heads * Dh * 2 + 2 * E * cfg.n_kv_heads * Dh + 3 * E * F
    return 2 * V * E + E + cfg.n_layers * layer


def _digest(a) -> str:
    """sha256 of an array's bytes, without a copy."""
    import numpy as np

    return hashlib.sha256(memoryview(np.ascontiguousarray(a).reshape(-1).view(np.uint8))
                          ).hexdigest()


def _ring_ranks(store, tag: str, cols: list, body) -> list:
    """Configures ``cols`` as one ring under ``tag`` and runs ``body(c, r)``
    on each rank in its own thread; shuts every rank down."""
    n = len(cols)

    def rank(r: int):
        cols[r].configure(f"{store.address()}/{tag}", r, n)
        return body(cols[r], r)

    try:
        with ThreadPoolExecutor(max_workers=n) as pool:
            futs = [pool.submit(rank, r) for r in range(n)]
            return [f.result(timeout=2 * BARE_RING_TIMEOUT_S) for f in futs]
    finally:
        for c in cols:
            c.shutdown()


def bare_ring(card: str, beside: str) -> dict:
    """Two in-process ranks allreduce the flagship's gradient payload over
    127.0.0.1 in each of BARE_RING_CONFIGS, each op on a fresh copy handed
    over with ``donate=True`` (as the averager hands its pinned buffers).
    The Python and native engines' results must be bitwise equal on the f32
    wire and under each codec, and every shm result bitwise equal to the
    TCP result of the same engine, wire and codec.  ``beside`` names what
    ran on the host and the card meanwhile; every timing line says it."""
    import numpy as np

    from torchft_tpu_torch._native import StoreServer
    from torchft_tpu_torch.collectives import TCPCollective

    n = flagship_param_count()
    data = [np.random.default_rng(11 + r).standard_normal(n, dtype=np.float32) for r in range(2)]
    exact = data[0] + data[1]  # two addends: one IEEE sum, in any order
    store = StoreServer(bind="127.0.0.1:0")
    report = {"payload_bytes": 4 * n, "ops": {}, "beside": beside}
    card = f"{card}; taken beside {beside}"
    outs, digests = {}, {}
    try:
        for i, (engine, lanes, wire, codec, transport) in enumerate(BARE_RING_CONFIGS):
            cols = [TCPCollective(timeout=BARE_RING_TIMEOUT_S, wire_dtype=wire, lanes=lanes,
                                  engine=engine, host="127.0.0.1", transport=transport)
                    for _ in range(2)]
            barrier = threading.Barrier(2)

            def body(c, r: int, barrier=barrier, engine=engine, codec=codec,
                     transport=transport):
                if c.ring_engine != engine or c.ring_transport != transport:
                    raise AssertionError(f"bare ring: asked for {engine} on {transport}, ran "
                                         f"{c.ring_engine} on {c.ring_transport}")
                kwargs = {} if codec is None else {"wire_codec": codec}
                secs, out = [], None
                for _ in range(BARE_RING_REPEATS):
                    buf = data[r].copy()
                    barrier.wait(timeout=BARE_RING_TIMEOUT_S)
                    t0 = time.perf_counter()
                    (out,) = c.allreduce([buf], donate=True, **kwargs).wait(
                        timeout=BARE_RING_TIMEOUT_S)
                    secs.append(time.perf_counter() - t0)
                return secs, out

            got = _ring_ranks(store, f"bare/{i}", cols, body)
            if got[0][1].view(np.uint32).tobytes() != got[1][1].view(np.uint32).tobytes():
                raise AssertionError(f"bare ring {engine}/{lanes}/{wire}/{transport}: the ranks "
                                     f"differ")
            secs = [max(a, b) for a, b in zip(got[0][0], got[1][0])]
            key = (f"{engine}, {lanes} lane{'s' if lanes > 1 else ''}, "
                   + (f"{codec} codec" if codec else f"{wire} wire") + f", {transport}")
            wire_bytes = cols[0].wire_nbytes(data[0], True, codec)
            report["ops"][key] = {"s": secs, "gb_per_s": [4 * n / s / 1e9 for s in secs],
                                  "wire_bytes_per_hop": wire_bytes}
            print(f"  {key}: " + ", ".join(f"{s:.3f} s ({4 * n / s / 1e9:.2f} GB/s)" for s in secs)
                  + f" for {4 * n / 1e6:.1f} MB of f32, {wire_bytes / 1e6:.1f} MB a hop "
                  f"({card})", flush=True)
            digest = _digest(got[0][1])
            if transport == "shm":
                # The f32 sum's TCP twin is the native 2-lane run's (the
                # Python engine's TCP run has 1 lane; both are a + b).
                twin = digests.get(("native" if wire == "f32" and codec is None else engine, 2,
                                    wire, codec, "tcp"))
                same = twin is not None and twin == digest
                print(f"    shm bitwise equal to TCP ({engine}, {wire}, {codec}): {same}",
                      flush=True)
                report.setdefault("shm_tcp_bitwise", {})[key] = same
                if not same:
                    raise AssertionError(f"bare ring {key}: the shm result differs from TCP's")
                if wire == "f32" and codec is None and digest != _digest(exact):
                    raise AssertionError(f"bare ring {key}: the sum is not a + b bit for bit")
                del got
                continue
            digests[(engine, lanes, wire, codec, transport)] = digest
            if codec:
                # Two quantizations at most per element (the reduce-scatter
                # hop and the allgather owner), each within half a step.
                a, b = data
                qmax = 127.0 if codec == "int8" else 7.0
                tol = (np.abs(a).max() + np.abs(exact).max()) / qmax
                err = float(np.abs(got[0][1] - exact).max())
                print(f"    max |sum - a - b| {err:.4g} (allowed {tol:.4g})", flush=True)
                if not err <= tol:
                    raise AssertionError(f"bare ring {key}: the sum is off by {err} > {tol}")
                outs[(engine, codec)] = got[0][1]
            elif wire == "f32":
                outs[(engine, None)] = got[0][1]
                if not np.array_equal(got[0][1].view(np.uint32), exact.view(np.uint32)):
                    raise AssertionError(f"bare ring {key}: the sum is not a + b bit for bit")
            else:
                a, b = data
                if not (np.abs(got[0][1] - exact) <= 2.0 ** -7 * (np.abs(a) + np.abs(b))).all():
                    raise AssertionError(f"bare ring {key}: the sum is off by more than bf16 "
                                         f"rounding")
            del got
    finally:
        store.shutdown()
    for codec in (None, "int8", "int4"):
        same = np.array_equal(outs[("py", codec)].view(np.uint32),
                              outs[("native", codec)].view(np.uint32))
        what = f"{codec} codec" if codec else "f32"
        print(f"  py and native {what} results bitwise equal: {same}", flush=True)
        report.setdefault("py_native_bitwise", {})[what] = same
        if not same:
            raise AssertionError(f"bare ring: the Python and native engines' {what} results "
                                 f"differ")
    same = (digests[("py", 2, "bf16", None, "tcp")] == digests[("native", 2, "bf16", None, "tcp")])
    print(f"  py and native bf16 wire results bitwise equal: {same}", flush=True)
    report["py_native_bitwise"]["bf16 wire"] = same
    if not same:
        raise AssertionError("bare ring: the Python and native engines' bf16 results differ")
    del outs
    report.update(ring_ops(card, data, exact))
    print("BARE_RING " + json.dumps(report), flush=True)
    return report


def ring_ops(card: str, data: list, exact) -> dict:
    """The rest of phase 7 on the flagship payload: max and min (exact), a
    shaped link (``shape_s`` > 0), a 4-rank ring2d in this process, and
    the ops beyond allreduce at 2 ranks, each checked exactly against
    numpy; every op timed."""
    import numpy as np

    from torchft_tpu_torch._native import StoreServer
    from torchft_tpu_torch.collectives import TCPCollective

    n = data[0].size
    store = StoreServer(bind="127.0.0.1:0")
    out: dict = {}

    def native(**kw):
        return TCPCollective(timeout=BARE_RING_TIMEOUT_S, lanes=2, engine="native",
                             host="127.0.0.1", **kw)

    # Each timed op starts with its input copied and both ranks at a barrier.
    pair, quad_barrier = threading.Barrier(2), threading.Barrier(RING2D_RANKS)
    try:
        # max and min: exact on any wire order.
        def minmax(c, r):
            res = {}
            for op in ("max", "min"):
                buf = data[r].copy()
                pair.wait(timeout=BARE_RING_TIMEOUT_S)
                t0 = time.perf_counter()
                (o,) = c.allreduce([buf], op=op, donate=True).wait(
                    timeout=BARE_RING_TIMEOUT_S)
                res[op] = (time.perf_counter() - t0, _digest(o),
                           _digest(np.maximum(*data) if op == "max" else np.minimum(*data)))
            return res

        got = _ring_ranks(store, "ops/minmax", [native(), native()], minmax)
        for op in ("max", "min"):
            secs = max(g[op][0] for g in got)
            ok = all(g[op][1] == g[op][2] for g in got)
            out[f"allreduce_{op}"] = {"s": secs, "exact": ok}
            print(f"  allreduce op={op} (native, 2 lanes, f32): {secs:.3f} s, equal to "
                  f"np.{'maximum' if op == 'max' else 'minimum'} bit for bit: {ok} ({card})",
                  flush=True)
            if not ok:
                raise AssertionError(f"allreduce op={op} is not exact")

        # A shaped link, set after an unshaped configure.
        def shaped(c, r):
            c.set_link_shaping(SHAPED_MBPS, SHAPED_RTT_MS)
            buf = data[r].copy()
            pair.wait(timeout=BARE_RING_TIMEOUT_S)
            t0 = time.perf_counter()
            (o,) = c.allreduce([buf], donate=True).wait(timeout=BARE_RING_TIMEOUT_S)
            secs = time.perf_counter() - t0
            return secs, c.lane_stats()["hops"]["flat"]["shape_s"], _digest(o)

        got = _ring_ranks(store, "ops/shaped", [native(), native()], shaped)
        secs, shape_s = max(g[0] for g in got), min(g[1] for g in got)
        exact_ok = all(g[2] == _digest(exact) for g in got)
        out["shaped"] = {"mbps": SHAPED_MBPS, "rtt_ms": SHAPED_RTT_MS, "s": secs,
                         "shape_s": [g[1] for g in got], "exact": exact_ok}
        print(f"  shaped link {SHAPED_MBPS:.0f} Mbps / {SHAPED_RTT_MS} ms RTT (native, 2 lanes, "
              f"f32): {secs:.3f} s, shape_s {[round(g[1], 4) for g in got]} s, a + b bit for "
              f"bit: {exact_ok} ({card})", flush=True)
        if not (shape_s > 0 and exact_ok):
            raise AssertionError(f"shaped link: shape_s {shape_s}, exact {exact_ok}")

        # ring2d: 4 ranks on a 2 x 2 grid.
        rng = np.random.default_rng(21)
        quad = data + [rng.standard_normal(n, dtype=np.float32)
                       for _ in range(RING2D_RANKS - 2)]

        def ring2d(c, r):
            buf = quad[r].copy()
            quad_barrier.wait(timeout=BARE_RING_TIMEOUT_S)
            t0 = time.perf_counter()
            (o,) = c.allreduce([buf], donate=True).wait(timeout=BARE_RING_TIMEOUT_S)
            return time.perf_counter() - t0, o, c.topology, c.lane_stats()

        got = _ring_ranks(store, "ops/ring2d",
                          [native(topology="ring2d") for _ in range(RING2D_RANKS)], ring2d)
        first = _digest(got[0][1])
        consistent = all(_digest(g[1]) == first for g in got)
        exact4 = np.zeros(n, dtype=np.float64)
        mag = np.zeros(n, dtype=np.float64)
        for q in quad:
            exact4 += q
            mag += np.abs(q)
        err = np.abs(got[0][1].astype(np.float64) - exact4)
        tol = (RING2D_RANKS - 1) * 2.0 ** -24 * mag
        ratio = float((err / np.maximum(tol, np.finfo(np.float64).tiny)).max())
        tiers = {k: v["size"] for k, v in got[0][3].get("tiers", {}).items()}
        secs = max(g[0] for g in got)
        out["ring2d"] = {"ranks": RING2D_RANKS, "s": secs, "replica_bitwise": consistent,
                         "err_over_tol": ratio, "tiers": tiers,
                         "topology": sorted({g[2] for g in got})}
        print(f"  ring2d, {RING2D_RANKS} ranks (native, 2 lanes, f32): {secs:.3f} s, tiers "
              f"{tiers}, bitwise across ranks: {consistent}, worst |err| / ((ranks - 1) 2^-24 "
              f"sum|x|) {ratio:.3g} ({card})", flush=True)
        del got, exact4, mag, err, tol
        if not (consistent and ratio <= 1.0 and set(tiers) == {"row", "col"}
                and out["ring2d"]["topology"] == ["ring2d"]):
            raise AssertionError(f"ring2d: {out['ring2d']}")

        # The ops beyond allreduce, at 2 ranks, exactly against numpy.
        half = n // 2

        def ops(c, r):
            times, res = {}, {}

            def timed(name, fn):
                pair.wait(timeout=BARE_RING_TIMEOUT_S)
                t0 = time.perf_counter()
                v = fn()
                times[name] = time.perf_counter() - t0
                return v

            ag = timed("allgather", lambda: c.allgather(data[r]).wait(timeout=BARE_RING_TIMEOUT_S))
            res["allgather"] = [_digest(a) for a in ag] == [_digest(d) for d in data]
            del ag
            bc = timed("broadcast", lambda: c.broadcast(data[r], root=1).wait(
                timeout=BARE_RING_TIMEOUT_S))
            res["broadcast"] = _digest(bc) == _digest(data[1])
            del bc
            rs = timed("reduce_scatter", lambda: c.reduce_scatter(
                [data[r][:half], data[r][half:2 * half]]).wait(timeout=BARE_RING_TIMEOUT_S))
            want = data[0][r * half:(r + 1) * half] + data[1][r * half:(r + 1) * half]
            res["reduce_scatter"] = _digest(rs) == _digest(want)
            del rs, want
            a2a = timed("alltoall", lambda: c.alltoall([data[r][:half], data[r][half:2 * half]])
                        .wait(timeout=BARE_RING_TIMEOUT_S))
            res["alltoall"] = [_digest(a) for a in a2a] == [
                _digest(data[src][r * half:(r + 1) * half]) for src in range(2)]
            del a2a

            def p2p():
                sent = c.send(data[r], 1 - r, tag=7)
                got = c.recv(data[r].shape, np.float32, 1 - r, tag=7).wait(
                    timeout=BARE_RING_TIMEOUT_S)
                sent.wait(timeout=BARE_RING_TIMEOUT_S)
                return got

            rv = timed("send_recv", p2p)
            res["send_recv"] = _digest(rv) == _digest(data[1 - r])
            del rv
            timed("barrier", lambda: c.barrier().wait(timeout=BARE_RING_TIMEOUT_S))
            res["barrier"] = True
            return times, res

        got = _ring_ranks(store, "ops/rest", [native(), native()], ops)
        out["other_ops"] = {}
        for name in got[0][0]:
            secs = max(g[0][name] for g in got)
            ok = all(g[1][name] for g in got)
            out["other_ops"][name] = {"s": secs, "exact": ok}
            print(f"  {name} (native, 2 lanes, 2 ranks, {4 * n / 1e6:.1f} MB a rank): "
                  f"{secs:.3f} s, exact: {ok} ({card})", flush=True)
            if not ok:
                raise AssertionError(f"{name} is not exact")
    finally:
        store.shutdown()
    return out


# -- phase 8: the raw-step profile ---------------------------------------------


def profile_phase(card: str) -> dict:
    """``tools/profile_step`` over PROFILE_STEPS chained flagship raw steps:
    fails without device events, and unless K1-K5 launch 12 / 12 / 12 / 1 /
    1 times a step."""
    from torchft_tpu_torch.models import flagship_config
    from torchft_tpu_torch.tools import profile_step

    cfg, _, _ = flagship_config()
    out_dir = tempfile.mkdtemp(prefix="tpuft_profile_")
    try:
        path = profile_step.capture(os.path.join(out_dir, "trace.json"), PROFILE_STEPS)
        rep = profile_step.build_report(path, PROFILE_STEPS)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    if rep["device_total_ms_per_step"] is None:
        raise AssertionError(f"profile: {rep['device_absent']}")
    print(f"  {PROFILE_STEPS} chained full_steps: wall {rep['wall_ms_per_step']:.3f} ms/step, "
          f"device ops {rep['device_total_ms_per_step']:.3f} ms/step, device busy share "
          f"{rep['device_busy_share']}, {rep['device_events']} device events, "
          f"{rep['distinct_ops']} distinct ops ({card})", flush=True)
    for op in rep["ops"]:
        print(f"    {op['ms_per_step']:9.4f} ms/step {op['launches_per_step']:6.1f}/step "
              f"[{op['category']}] {op['name'][:100]}", flush=True)
    print("  by op class:", flush=True)
    for c in rep["by_class"]:
        print(f"    {c['ms_per_step']:9.4f} ms/step  {c['op_class']}", flush=True)
    want = {"flash_fwd_kernel": cfg.n_layers, "flash_bwd_dkdv_kernel": cfg.n_layers,
            "flash_bwd_dq_kernel": cfg.n_layers, "ce_lse_kernel": 1, "ce_dlogits_kernel": 1}
    got = {k: profile_step.launches_per_step(rep, k) for k in want}
    print(f"  K1-K5 launches a step in the trace: {got}", flush=True)
    if got != want:
        raise AssertionError(f"profile: kernel launches a step {got}, expected {want}")
    print("PROFILE " + json.dumps({k: v for k, v in rep.items() if k != "launches"}),
          flush=True)
    return rep


# -- phase 9: the semisync codec's device encoders -------------------------------

CODEC_FRAGMENT_ELEMS = 1 << 20  # one default 4 MB fragment of f32
CODEC_REPS = 5                  # CUDA-event repeats of each device encode


def _bits_equal(a, b) -> bool:
    import numpy as np

    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def codec_case(name: str, n: int, device: str, seed: int, special: bool) -> dict:
    """One fragment of ``n`` f32 elements through two rounds (commit, then
    an encode with the residual carried) of the ``name`` codec twice: host
    leaves (the numpy path) and device leaves (the torch-op path).  Each
    round's payload and residual must be bitwise equal, the device path
    must fetch q and the scale only (n + 4 bytes), and its q must be the
    host quantizer's.  Planted faults (finite inputs): a device encode
    whose residual was not carried, and the payload dequantized with the
    scale one ulp up, must both differ from the host's bits."""
    import numpy as np
    import torch

    from torchft_tpu_torch.collectives import quantize_int4, quantize_int8
    from torchft_tpu_torch.semisync import FragmentPlan, make_codec
    from torchft_tpu_torch.semisync.codec import ef_quantize

    qmax = 127 if name == "int8" else 7
    host_quantize = quantize_int8 if name == "int8" else quantize_int4
    frag = FragmentPlan([((n,), torch.float32)], 4 * n).fragments[0]
    host, dev, nocarry = (make_codec(name, frag) for _ in range(3))
    gen = torch.Generator(device=device).manual_seed(seed)
    rec = {"name": name, "elements": n, "special": special}
    for rnd in range(2):
        backup = torch.randn(n, generator=gen, device=device)
        local = backup + 0.01 * torch.randn(n, generator=gen, device=device)
        if special and rnd == 1:
            local[::97] = float("nan")
            local[1::101] = float("inf")
            local[2::103] = float("-inf")
        backup_h, local_h = backup.cpu(), local.cpu()
        for c in (host, dev, nocarry):
            c.set_backup(backup_h)
        res_dev = dev._residual_on(local.device).clone()
        t0 = time.perf_counter()
        want, d2h_h = host.encode([local_h])
        host_ms = (time.perf_counter() - t0) * 1e3
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, d2h = dev.encode([local])
        full_ms = (time.perf_counter() - t0) * 1e3
        fault, _ = nocarry.encode([local])
        if not _bits_equal(got, want):
            raise AssertionError(f"codec {name} n={n} round {rnd}: device payload differs")
        got_res = (dev._pending_residual.cpu().numpy() if dev._pending_on_device
                   else dev._pending_residual)
        if not _bits_equal(got_res, host._pending_residual):
            raise AssertionError(f"codec {name} n={n} round {rnd}: residuals differ")
        if device == "cuda" and d2h != n + 4:
            raise AssertionError(f"codec {name}: the device path fetched {d2h} bytes, not "
                                 f"q + scale ({n + 4})")
        # q itself against the host quantizer on the same x.
        q, scale, _ = ef_quantize(local, backup, res_dev, qmax)
        x_h = (backup_h.numpy() - local_h.numpy()) + res_dev.cpu().numpy()
        s_h, q_h = host_quantize(x_h)
        if not (_bits_equal(q.cpu().numpy(), q_h) and float(scale) == np.float32(s_h)):
            raise AssertionError(f"codec {name} n={n} round {rnd}: q or the scale differs "
                                 f"from the host quantizer")
        up = torch.nextafter(scale, torch.tensor(float("inf"), device=scale.device))
        scale_fault = _bits_equal((q.to(torch.float32) * up).cpu().numpy(), want)
        residual_fault = _bits_equal(fault, want)
        if rnd == 1 and not special:
            print(f"    planted faults: residual not carried rejected {not residual_fault}, "
                  f"scale one ulp up rejected {not scale_fault}", flush=True)
            if residual_fault or scale_fault:
                raise AssertionError(f"codec {name} n={n}: a planted fault was accepted")
        for c in (host, dev):
            c.on_commit()
        nocarry.on_abort()
        rec[f"round{rnd}"] = {"host_encode_ms": host_ms, "device_encode_d2h_ms": full_ms,
                              "d2h_bytes": d2h, "nonzero_q": int((q != 0).sum())}
    if device == "cuda":
        res = dev._residual_on(local.device)
        rec["device_encode_ms"] = cuda_ms(lambda: ef_quantize(local, backup, res, qmax),
                                          CODEC_REPS)
        # Read local, backup and the residual, write q and the new residual.
        rec.update(bound(0, n * (4 * 4 + 1)))
    return rec


def codec_phase(card: str, device: str = "cuda") -> dict:
    """The int8 and int4 device encoders against the host quantizers,
    bitwise, at one 4 MB fragment and at the flagship's whole f32 vector,
    and a NaN / inf case; prints each encode's times."""
    out = []
    sizes = ((CODEC_FRAGMENT_ELEMS, False), (CODEC_FRAGMENT_ELEMS, True),
             (flagship_param_count(), False))
    for name in ("int8", "int4"):
        for n, special in sizes:
            rec = codec_case(name, n, device, seed=31 + n % 97, special=special)
            r1 = rec["round1"]
            print(f"  {name}, {n} f32 elements{' with NaN / inf' if special else ''}: device "
                  f"and host payloads and residuals bitwise equal over 2 rounds; device "
                  f"encode {rec.get('device_encode_ms', float('nan')):.4f} ms (CUDA events; "
                  f"bound {rec.get('bound_ms', float('nan')):.4f} ms by bytes), encode + "
                  f"copy off {r1['device_encode_d2h_ms']:.3f} ms, host encode "
                  f"{r1['host_encode_ms']:.1f} ms, {r1['d2h_bytes']} bytes fetched ({card})",
                  flush=True)
            out.append(rec)
    print("CODEC " + json.dumps(out), flush=True)
    return {"cases": out}


# -- phase 10: Streaming DiLoCo on the flagship ----------------------------------

DILOCO_SYNC_EVERY = 8   # inner steps a round
# The DiLoCo path's depth: the flagship's width at half its 12 layers, cut
# since PR 9 so the healing phase fits the run's time.
DILOCO_LAYERS = 6


def diloco_config():
    """The flagship's (config, batch, seq) at DILOCO_LAYERS layers."""
    return cut_config(DILOCO_LAYERS)


def cut_config(layers: int):
    """The flagship's (config, batch, seq) at ``layers`` layers: its widths,
    its batch and its sequence kept."""
    import dataclasses

    from torchft_tpu_torch.models import flagship_config

    cfg, batch, seq = flagship_config()
    return dataclasses.replace(cfg, n_layers=layers), batch, seq
DILOCO_SOLO_ROUNDS = 1  # rounds group 0 commits before group 1 starts
DILOCO_ROUNDS = 3       # group 0's rounds in all; group 1 heals into the second


def run_diloco_group(args: argparse.Namespace) -> None:
    """One replica group of the DiLoCo phase: the flagship trained by
    AdamW inner steps through TrainStep under StreamingDiLoCo (int8 codec,
    default 4 MB fragments, synchronous quorum)."""
    import logging
    from datetime import timedelta

    import torch

    from torchft_tpu_torch.checkpointing import HTTPTransport
    from torchft_tpu_torch.collectives import TCPCollective
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.models import Transformer, loss_fn, resolve_device
    from torchft_tpu_torch.ops import launch_counts, reset_launch_counts
    from torchft_tpu_torch.parallel import TrainStep
    from torchft_tpu_torch.semisync import StreamingDiLoCo, outer

    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format=f"[d{args.diloco_group}] %(message)s")
    group, run_dir = args.diloco_group, args.run_dir
    cfg, batch, seq = diloco_config()
    dev = resolve_device(args.device)
    model = Transformer(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(2000 + group))
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    params = list(model.parameters())
    timeout = timedelta(seconds=180)
    collective = TCPCollective(timeout=180.0, host="127.0.0.1")
    transport = HTTPTransport(timeout=180.0, host="127.0.0.1")
    manager = Manager(
        collective=collective,
        load_state_dict=lambda sd: (model.load_state_dict(sd["model"]),
                                    opt.load_state_dict(sd["optim"])),
        state_dict=lambda: {"model": model.state_dict(), "optim": opt.state_dict()},
        min_replica_size=1, use_async_quorum=False, rank=0, world_size=1,
        replica_id=f"diloco_g{group}", lighthouse_addr=args.lighthouse, store_addr="127.0.0.1",
        manager_bind="127.0.0.1:0", checkpoint_transport=transport, timeout=timeout,
        quorum_timeout=timeout,
    )

    def set_params(src) -> None:
        with torch.no_grad():
            for p, s in zip(params, src):
                p.copy_(s)

    algo = StreamingDiLoCo(manager, lambda: params, set_params,
                           outer.sgd(0.7, momentum=0.9, nesterov=True),
                           sync_every=DILOCO_SYNC_EVERY, codec="int8")
    # The outer step's time (CPU), read around the method the round calls.
    apply_ms: list = []
    inner_apply = algo._apply

    def timed_apply(results):
        t0 = time.perf_counter()
        try:
            return inner_apply(results)
        finally:
            apply_ms.append((time.perf_counter() - t0) * 1e3)

    algo._apply = timed_apply
    trainer = TrainStep(model, opt, loss_fn)
    data = torch.Generator(device=dev).manual_seed(70 + group)

    def wait_for(path: str) -> None:
        deadline = time.monotonic() + GROUP_TIMEOUT_S
        while not os.path.exists(path):
            if time.monotonic() > deadline:
                raise TimeoutError(f"group {group}: {path} never appeared")
            time.sleep(0.05)

    rounds, inner_ms, boundary_ms = [], [], []
    healed = False
    reset_launch_counts()
    inner_steps = 0
    with algo:
        while manager.current_step() < DILOCO_ROUNDS:
            if len(rounds) > 2 * DILOCO_ROUNDS:
                raise RuntimeError("the DiLoCo groups never finished their rounds")
            before = manager.current_step()
            losses = []
            for k in range(DILOCO_SYNC_EVERY):
                tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=data,
                                       device=dev)
                b = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}
                t0 = time.perf_counter()
                loss = trainer.full_step(b)
                losses.append(float(loss))  # waits for the step's kernels
                t1 = time.perf_counter()
                if group == 1 and inner_steps == 0:
                    # This step's quorum request must reach the lighthouse
                    # before group 0's next one (a quorum of group 0's
                    # previous members forms at once); it blocks until both
                    # have asked, so group 0 goes on a grace after it.
                    threading.Timer(JOIN_GRACE_S, lambda: open(
                        os.path.join(run_dir, "g1_up"), "w").close()).start()
                algo.step()
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                t2 = time.perf_counter()
                inner_steps += 1
                if k == DILOCO_SYNC_EVERY - 1:
                    boundary_ms.append((t2 - t1) * 1e3)
                elif k > 0:
                    inner_ms.append({"round": len(rounds), "ms": (t2 - t0) * 1e3,
                                     "participants": manager.num_participants()})
            jumped = manager.current_step() - before > 1
            healed |= jumped
            rec = {"group": group, "step": manager.current_step(),
                   "committed": manager.current_step() > before, "healed": jumped,
                   "participants": manager.num_participants(), "losses": losses,
                   "fragments": algo.metrics.fragments_total,
                   "wire_bytes_total": algo.metrics.wire_bytes_total,
                   "d2h_bytes_total": algo.metrics.d2h_bytes_total}
            rounds.append(rec)
            print("ROUND " + json.dumps(rec), flush=True)
            if not rec["committed"]:
                raise RuntimeError(f"group {group}: the round from step {before} did not commit")
            if not all(math.isfinite(v) for v in losses):
                raise RuntimeError(f"group {group}: a loss is not finite: {losses}")
            if group == 0 and manager.current_step() == DILOCO_SOLO_ROUNDS:
                open(os.path.join(run_dir, "g0_ready"), "w").close()
                wait_for(os.path.join(run_dir, "g1_up"))
        counts = launch_counts()
        # The semi-sync section rides the Manager's worker endpoint; the
        # DiLoCo exporter binds no port of its own.
        sc = worker_scrape(manager, check_lanes=False)
        scrape = {"port": sc["port"], "bytes": sc["bytes"], "ms": sc["ms"],
                  "semisync_series": sum(1 for k in sc["samples"]
                                         if k.startswith("tpuft_semisync_")),
                  "worker_series": sum(1 for k in sc["samples"] if k.startswith("tpuft_worker_")),
                  "second_port": algo.metrics._server is not None}

    def sha(tensors) -> str:
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()
                     .tobytes())
        return h.hexdigest()

    plan = algo.plan
    params_sha, backup_sha = sha(params), sha(algo.backup_params)
    # The compute alone (no round in flight), timed after the rounds.
    raw = []
    for _ in range(RAW_STEPS):
        t0 = time.perf_counter()
        float(trainer.full_step(b))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        raw.append((time.perf_counter() - t0) * 1e3)
    result = {
        "group": group, "rounds": rounds, "final_step": manager.current_step(),
        "healed": healed, "inner_steps": inner_steps, "launches": counts,
        "params_sha256": params_sha, "backup_sha256": backup_sha,
        "fragments": len(plan), "fragment_f32_bytes": plan.total_bytes,
        "fragment_elements": sum(f.numel for f in plan.fragments),
        "inner_ms": inner_ms, "boundary_ms": boundary_ms, "outer_apply_ms": apply_ms,
        "raw_full_step_ms": raw,
        "engine": collective.ring_engine, "lanes": collective.lanes,
        "codec_paths": sorted({type(c).__name__ for c in algo._codecs}),
        "losses_final": rounds[-1]["losses"][-1],
        "worker_scrape": scrape,
    }
    manager.shutdown()
    print("RESULT " + json.dumps(result), flush=True)


def diloco_phase(card: str, device: str = "cuda") -> dict:
    """A lighthouse and two DiLoCo groups as processes on the card: group 0
    runs DILOCO_SOLO_ROUNDS alone, group 1 joins and heals the weights, the
    AdamW state and the outer state, and both run to DILOCO_ROUNDS.
    Returns the K1-K5 launch counts of both groups' runs."""
    from torchft_tpu_torch._native import LighthouseServer
    from torchft_tpu_torch.obs import report, trace

    lighthouse = LighthouseServer(bind="127.0.0.1:0", http_bind="127.0.0.1:0",
                                  min_replicas=1, join_timeout_ms=100)
    run_dir = tempfile.mkdtemp(prefix="tpuft_diloco_")
    procs, readers, results = {}, {}, {}

    def start(group: int) -> None:
        env = {**os.environ, **WORKER_METRICS_ENV,
               "TPUFT_METRICS_PATH": os.path.join(run_dir, f"metrics_d{group}.jsonl")}
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--diloco-group", str(group),
             "--lighthouse", lighthouse.address(), "--run-dir", run_dir, "--device", device],
            stdout=subprocess.PIPE, text=True, cwd=HERE, env=env)
        procs[group] = proc

        def read() -> None:
            assert proc.stdout is not None
            for line in proc.stdout:
                line = line.rstrip("\n")
                print(f"  [d{group}] {line}", flush=True)
                if line.startswith("RESULT "):
                    results[group] = json.loads(line[len("RESULT "):])

        readers[group] = threading.Thread(target=read, daemon=True)
        readers[group].start()

    try:
        t_start = time.monotonic()
        start(0)
        while not os.path.exists(os.path.join(run_dir, "g0_ready")):
            for g, p in procs.items():
                if p.poll() not in (None, 0):
                    raise RuntimeError(f"DiLoCo group {g} exited with {p.returncode}")
            if time.monotonic() - t_start > GROUP_TIMEOUT_S:
                raise TimeoutError("DiLoCo group 0 never committed its solo round")
            time.sleep(0.1)
        start(1)
        for g, p in procs.items():
            rc = p.wait(timeout=GROUP_TIMEOUT_S)
            readers[g].join(timeout=30)
            if rc != 0:
                raise RuntimeError(f"DiLoCo group {g} exited with {rc}")
        paths = [os.path.join(run_dir, f"metrics_d{g}.jsonl") for g in (0, 1)]
        streams = {g: report.read_events([p]) for g, p in zip((0, 1), paths)}
        events = report.read_events(paths)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        lighthouse.shutdown()
        shutil.rmtree(run_dir, ignore_errors=True)

    r0, r1 = results[0], results[1]
    if not (r0["final_step"] == r1["final_step"] == DILOCO_ROUNDS):
        raise AssertionError(f"final steps {r0['final_step']}, {r1['final_step']}")
    if not r1["healed"] or r0["healed"]:
        raise AssertionError("expected group 1, and only group 1, to heal")
    want = {0: [1] * DILOCO_SOLO_ROUNDS + [2] * (DILOCO_ROUNDS - DILOCO_SOLO_ROUNDS),
            1: [2] * (DILOCO_ROUNDS - DILOCO_SOLO_ROUNDS)}
    for r in (r0, r1):
        got = [x["participants"] for x in r["rounds"]]
        if got != want[r["group"]]:
            raise AssertionError(f"DiLoCo group {r['group']}: participants a round {got}, "
                                 f"expected {want[r['group']]}")
    if r0["params_sha256"] != r1["params_sha256"] or r0["backup_sha256"] != r1["backup_sha256"]:
        raise AssertionError("the DiLoCo groups' final parameters or backups differ")
    cfg, _, _ = diloco_config()
    per_step = {"flash_fwd": cfg.n_layers, "flash_bwd_dkdv": cfg.n_layers,
                "flash_bwd_dq": cfg.n_layers, "ce_lse": 1, "ce_dlogits": 1}
    for r in (r0, r1):
        if device == "cuda":
            for name, k in per_step.items():
                if r["launches"].get(name) != k * r["inner_steps"]:
                    raise AssertionError(f"DiLoCo group {r['group']}: {name} launched "
                                         f"{r['launches'].get(name)} times, expected "
                                         f"{k * r['inner_steps']}")
        if (r["engine"], r["lanes"]) != ("native", 2) or r["codec_paths"] != ["_Int8EFCodec"]:
            raise AssertionError(f"DiLoCo group {r['group']}: ring {r['engine']}/{r['lanes']}, "
                                 f"codecs {r['codec_paths']}")
        sc = r["worker_scrape"]
        if sc["semisync_series"] == 0 or sc["worker_series"] == 0 or sc["second_port"]:
            raise AssertionError(f"DiLoCo group {r['group']}: the worker endpoint's scrape {sc}: "
                                 f"expected tpuft_semisync_* beside tpuft_worker_* on one port")
        print(f"  group {r['group']} worker /metrics (port {sc['port']}): "
              f"{sc['semisync_series']} tpuft_semisync_* and {sc['worker_series']} tpuft_worker_* "
              f"series on the Manager's port, no second port; {sc['bytes']} bytes in "
              f"{sc['ms']:.2f} ms ({card})", flush=True)
    f32_bytes = r0["fragment_f32_bytes"]
    for g, evs in streams.items():
        phases = {e["phase"] for e in evs if e["event"] == "span"}
        if "outer_sync" not in phases:
            raise AssertionError(f"DiLoCo group {g}: no outer_sync spans in {sorted(phases)}")
        rnds = [e for e in evs if e["event"] == "semisync_round"]
        if len(rnds) != len(results[g]["rounds"]) or not all(e["committed"] for e in rnds):
            raise AssertionError(f"DiLoCo group {g}: semisync_round events {rnds}")
        for e in rnds:
            ratio = e["wire_bytes"] / f32_bytes
            d2h_want = results[g]["fragment_elements"] + 4 * results[g]["fragments"]
            print(f"  group {g} round at step {e['step']}: {e['fragments']} fragments, wire "
                  f"{e['wire_bytes'] / 1e6:.2f} MB a hop ({ratio:.4f} of f32), copied off the "
                  f"card {e['d2h_bytes'] / 1e6:.2f} MB ({e['d2h_bytes'] / f32_bytes:.4f} of "
                  f"f32), residual l2 {e['residual_l2']}", flush=True)
            if not ratio <= 0.27:
                raise AssertionError(f"DiLoCo group {g}: wire {ratio:.4f} of f32 > 0.27")
            if device == "cuda" and e["d2h_bytes"] not in (0, d2h_want):
                raise AssertionError(f"DiLoCo group {g}: {e['d2h_bytes']} bytes copied off the "
                                     f"card, not int8 + 4 a fragment ({d2h_want})")
        if device == "cuda" and not any(e["d2h_bytes"] == d2h_want for e in rnds):
            raise AssertionError(f"DiLoCo group {g}: the device codec path never ran")
        merges = [e["duration_ms"] for e in evs if e["event"] == "span"
                  and e["phase"] == "allreduce_merge"]
        syncs = [e["duration_ms"] for e in evs if e["event"] == "span"
                 and e["phase"] == "outer_sync"]
        print(f"  group {g}: drain waits (allreduce_merge) "
              + ", ".join(f"{m:.1f}" for m in merges) + f" ms; {len(syncs)} outer_sync spans, "
              f"{sum(syncs):.1f} ms in all on the worker ({card})", flush=True)
    problems = trace.validate_trace(trace.build_trace(sorted(events, key=lambda e: e["ts"])))
    if problems:
        raise AssertionError(f"the DiLoCo trace does not validate: {problems}")
    for r in (r0, r1):
        merged = [x["ms"] for x in r["inner_ms"] if x["participants"] == 2]
        alone = [x["ms"] for x in r["inner_ms"] if x["participants"] == 1]
        mean = lambda xs: sum(xs) / len(xs) if xs else float("nan")  # noqa: E731
        print(f"  group {r['group']}: inner step {mean(merged):.1f} ms with a merged round in "
              f"flight ({len(merged)} steps), {mean(alone):.1f} ms in a solo round "
              f"({len(alone)}), raw full_step {mean(r['raw_full_step_ms']):.1f} ms after the "
              f"run; round boundary (drain, vote, outer step, write-back) "
              + ", ".join(f"{x:.1f}" for x in r["boundary_ms"]) + " ms; outer apply "
              + ", ".join(f"{x:.1f}" for x in r["outer_apply_ms"]) + f" ms ({card})",
              flush=True)
    print(f"  both groups: params_sha256 {r0['params_sha256']}, backup {r0['backup_sha256']}; "
          f"{r0['fragments']} fragments of {f32_bytes / 1e6:.1f} MB f32", flush=True)
    print("DILOCO " + json.dumps({"groups": [r0, r1]}), flush=True)
    return {name: r0["launches"].get(name, 0) + r1["launches"].get(name, 0)
            for name in per_step}


# -- phase 11: the healing plane on the flagship -----------------------------------

HEAL_BATCH = 16          # per group; three groups share the card
# The healing path's depth: the flagship's width at a quarter of its 12
# layers, cut so that phase 16 fits the run's time.
HEAL_LAYERS = 3
HEAL_MERGED = 2          # merged commits of every group between events
HEAL_PACE_MBPS = 300.0   # group 0's serving link in the failover event
HEAL_KILL_DELAY_S = 0.5  # from group 0's first paced stripe to its SIGKILL
HEAL_TIMEOUT_S = 420.0
HEAL_EC = {"TPUFT_EC_K": "2", "TPUFT_EC_M": "1"}


def _read_int(path: str):
    try:
        with open(path) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def run_heal_group(args: argparse.Namespace) -> None:
    """One replica group of the healing phase: the flagship under the FT
    loop with the erasure-coded plane on (TPUFT_EC_K/M from the parent).
    The parent steers it through files in the run directory: ``hold_<k>``
    (hold at the top of that step until ``join_<k>``, groups 0 and 1),
    ``pace_g0`` (group 0, held, paces its serving link to that many MB/s
    and writes ``serving_g0`` once it starts streaming a stripe after that)
    and ``stop`` (leave at that step).  A held group writes ``held_<k>_g<g>``;
    group 2 waits for both before its first quorum request and writes
    ``join_<incarnation>`` a grace after it.  Every step prints a STEP record with
    the parameters' sha256 and the transport's counters."""
    import logging
    from datetime import timedelta

    import torch

    from torchft_tpu_torch.checkpointing import HTTPTransport
    from torchft_tpu_torch.collectives import TCPCollective
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.models import Transformer, loss_fn, resolve_device
    from torchft_tpu_torch.ops import launch_counts, reset_launch_counts
    from torchft_tpu_torch.parallel import TrainStep

    group, inc, run_dir = args.heal_group, args.incarnation, args.run_dir
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format=f"[h{group}.{inc}] %(message)s")
    cfg, _, seq = cut_config(HEAL_LAYERS)
    dev = resolve_device(args.device)
    model = Transformer(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(3000))
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    timeout = timedelta(seconds=180)
    collective = TCPCollective(timeout=180.0, host="127.0.0.1")
    transport = HTTPTransport(timeout=180.0, host="127.0.0.1")
    manager = Manager(
        collective=collective,
        load_state_dict=lambda sd: (model.load_state_dict(sd["model"]),
                                    opt.load_state_dict(sd["optim"])),
        state_dict=lambda: {"model": model.state_dict(), "optim": opt.state_dict()},
        min_replica_size=1, rank=0, world_size=1, replica_id=f"heal_g{group}",
        lighthouse_addr=args.lighthouse, store_addr="127.0.0.1", manager_bind="127.0.0.1:0",
        checkpoint_transport=transport, timeout=timeout, quorum_timeout=timeout,
        init_sync=False,  # every group starts from the same seeded weights
    )
    trainer = TrainStep(model, opt, loss_fn, manager)
    data = torch.Generator(device=dev).manual_seed(300 + 10 * group + inc)
    path = lambda name: os.path.join(run_dir, name)  # noqa: E731
    paced = False
    steps_run = 0
    # The last fetch seen, and the heal's own when the healer fetches again
    # before its first record.
    last_fetch = transport.last_fetch
    heal_fetch = None
    reset_launch_counts()

    def pace() -> None:
        """Group 0, held: paces its link once the parent asks, and signals
        when it starts streaming a stripe after that."""
        nonlocal paced
        if paced or not os.path.exists(path("pace_g0")):
            return
        transport.set_shaped_mbps(float(_read_int(path("pace_g0"))))
        paced = True
        threading.Thread(target=signal_serving, args=(transport.served.get("chunk", 0),),
                         daemon=True).start()

    def signal_serving(chunks_before: int) -> None:
        while transport.served.get("chunk", 0) <= chunks_before:
            time.sleep(0.005)
        open(path("serving_g0"), "w").close()

    def wait_file(name: str, poll=None) -> None:
        deadline = time.monotonic() + HEAL_TIMEOUT_S
        while not os.path.exists(name):
            if time.monotonic() > deadline:
                raise TimeoutError(f"heal group {group}: {name} never appeared")
            if poll is not None:
                poll()
            time.sleep(0.02)

    def params_sha() -> str:
        flat = torch.cat([p.detach().reshape(-1).view(torch.uint8)
                          for p in model.parameters()])
        return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()

    while True:
        step = manager.current_step()
        stop = _read_int(path("stop"))
        if stop is not None and step >= stop:
            break
        if steps_run > 400:
            raise RuntimeError(f"heal group {group}: never reached the stop step")
        if group != 2:
            for k in (1, 2, 3):
                if _read_int(path(f"hold_{k}")) == step:
                    open(path(f"held_{k}_g{group}"), "w").close()
                    wait_file(path(f"join_{k}"), poll=pace if group == 0 else None)
        elif steps_run == 0:
            for g in (0, 1):
                wait_file(path(f"held_{inc}_g{g}"))
        manager.start_quorum()
        measured = None
        if group == 2 and steps_run == 0:
            # This request waits at the lighthouse for the held groups.
            time.sleep(JOIN_GRACE_S)
            open(path(f"join_{inc}"), "w").close()
            manager.wait_quorum()
            if transport.last_fetch is not last_fetch:
                heal_fetch = dict(transport.last_fetch)
            if inc == 1 and manager.current_step() > 0:
                measured = heal_modes(transport, manager.current_step())
                last_fetch = transport.last_fetch
        tokens = torch.randint(0, cfg.vocab_size, (HEAL_BATCH, seq), generator=data, device=dev)
        t0 = time.perf_counter()
        loss, committed = trainer.ft_step({"tokens": tokens,
                                           "targets": torch.roll(tokens, -1, dims=1)})
        loss_v = float(loss)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        steps_run += 1
        rec = {"group": group, "inc": inc, "before": step, "step": manager.current_step(),
               "committed": committed, "participants": manager.num_participants(),
               "loss": loss_v, "step_s": time.perf_counter() - t0, "t": time.time(),
               "steps_run": steps_run, "launches": launch_counts(),
               "served": dict(transport.served), "windows": transport.windows_opened,
               "peak_mem": torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0}
        if transport.last_fetch is not last_fetch:
            last_fetch = transport.last_fetch
            rec["fetch"] = dict(last_fetch)
        if heal_fetch is not None:
            rec["fetch"], heal_fetch = heal_fetch, None
        if measured is not None:
            rec["modes"] = measured
        if committed:
            rec["sha"] = params_sha()
        print("STEP " + json.dumps(rec), flush=True)
        if committed and not math.isfinite(loss_v):
            raise RuntimeError(f"heal group {group}: loss {loss_v} is not finite")
    transport.wait_snapshot(timeout=GROUP_TIMEOUT_S)
    manager.shutdown()


def heal_modes(transport, step: int) -> dict:
    """The healer's three fetches of the same state from the donors that
    just served its heal (their windows stay open until the step they wait
    on in the ring): one /full stream, one donor chunked, two donors
    striped.  Seconds and GB/s of each."""
    donors = transport.last_fetch["donors"]
    out = {}
    for name, meta, workers in (("full", donors[-1], "1"), ("chunked", donors[-1], None),
                                ("striped", donors, None)):
        if workers:
            os.environ["TPUFT_HTTP_CHUNK_WORKERS"] = workers
        try:
            got = transport.recv_checkpoint(0, meta, step, timeout=180.0)
        finally:
            os.environ.pop("TPUFT_HTTP_CHUNK_WORKERS", None)
        del got
        f = transport.last_fetch
        if f["mode"] != name:
            raise AssertionError(f"the {name} fetch ran as {f['mode']}: {f}")
        out[name] = {k: f[k] for k in ("bytes", "fetch_s", "n_donors", "n_stripes", "workers",
                                      "crc_ms", "crc_verified", "by_donor")}
        out[name]["gb_per_s"] = f["bytes"] / 1e9 / f["fetch_s"]
    return out


def healing_phase(card: str, beside: str, device: str = "cuda") -> dict:
    """A lighthouse and three flagship groups on the card with the
    erasure-coded plane (k 2, m 1).  (a) Groups 0 and 1 train merged; group
    2 joins and heals striped from both.  (b) Group 2 is SIGKILLed and
    restarted with TPUFT_EC_MODE=prefer: it heals from the survivors'
    shards.  (c) Group 2 is SIGKILLed and restarted on the donor path;
    group 0's link is paced and group 0 is SIGKILLed in the middle of the
    fetch: the stripes fail over to group 1.  ``beside`` names what ran on
    the host and the card meanwhile.  Returns what :func:`heal_checks`
    returns."""
    from torchft_tpu_torch._native import LighthouseServer
    from torchft_tpu_torch.models import flagship_config
    from torchft_tpu_torch.obs import report

    # The join timeout covers the held groups' quorum requests, which
    # follow the joiner's by a grace and each other by a file poll.
    lighthouse = LighthouseServer(bind="127.0.0.1:0", http_bind="127.0.0.1:0",
                                  min_replicas=2, join_timeout_ms=3000)
    run_dir = tempfile.mkdtemp(prefix="tpuft_heal_")
    procs, readers, recs = {}, {}, {}
    lock = threading.Lock()
    kills = []

    def metrics_path(g: int, inc: int) -> str:
        return os.path.join(run_dir, f"metrics_h{g}_{inc}.jsonl")

    def start(g: int, inc: int, env_extra: dict) -> None:
        env = {**os.environ, **HEAL_EC, **env_extra, "TPUFT_METRICS_PATH": metrics_path(g, inc)}
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--heal-group", str(g), "--incarnation",
             str(inc), "--lighthouse", lighthouse.address(), "--run-dir", run_dir,
             "--device", device], stdout=subprocess.PIPE, text=True, cwd=HERE, env=env)
        procs[(g, inc)] = proc
        recs[(g, inc)] = []

        def read() -> None:
            for line in proc.stdout:
                line = line.rstrip("\n")
                if line.startswith("STEP "):
                    rec = json.loads(line[len("STEP "):])
                    with lock:
                        recs[(g, inc)].append(rec)
                    short = {k: rec.get(k) for k in ("step", "committed", "participants",
                                                     "loss", "step_s")}
                    print(f"  [h{g}.{inc}] STEP {json.dumps(short)}", flush=True)
                else:
                    print(f"  [h{g}.{inc}] {line}", flush=True)

        readers[(g, inc)] = threading.Thread(target=read, daemon=True)
        readers[(g, inc)].start()

    def write(name: str, value) -> None:
        tmp = os.path.join(run_dir, name + ".tmp")
        with open(tmp, "w") as f:
            f.write(str(value))
        os.replace(tmp, os.path.join(run_dir, name))

    def merged_commits(key) -> list:
        with lock:
            return [r for r in recs[key] if r["committed"] and r["participants"] >= 2]

    def wait(cond, what: str) -> None:
        deadline = time.monotonic() + HEAL_TIMEOUT_S
        while not cond():
            for key, p in procs.items():
                if p.poll() not in (None, 0) and not any(key == k for k, _ in kills):
                    raise RuntimeError(f"heal group {key} exited with {p.returncode}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"healing phase: {what}")
            time.sleep(0.02)

    def top_step() -> int:
        with lock:
            return max((r["step"] for rs in recs.values() for r in rs), default=0)

    def kill(key) -> float:
        t = time.time()
        kills.append((key, t))
        procs[key].kill()
        procs[key].wait()
        return t

    t_phase = time.monotonic()
    try:
        start(0, 0, {})
        start(1, 0, {})
        wait(lambda: len(merged_commits((0, 0))) >= HEAL_MERGED, "groups 0 and 1 never merged")
        events = {}
        # (a) Group 2 joins and heals striped from groups 0 and 1.
        write("hold_1", top_step() + 2)
        start(2, 1, {})
        wait(lambda: len([r for r in merged_commits((2, 1)) if r["participants"] == 3])
             >= HEAL_MERGED, "group 2 never ran merged after its striped heal")
        # (b) SIGKILL group 2; restart it in prefer mode.
        events["kill_b"] = kill((2, 1))
        write("hold_2", top_step() + 2)
        start(2, 2, {"TPUFT_EC_MODE": "prefer"})
        wait(lambda: os.path.exists(os.path.join(run_dir, "join_2")), "group 2 never rejoined")
        events["join_b"] = time.time()
        wait(lambda: len([r for r in merged_commits((2, 2)) if r["participants"] == 3])
             >= HEAL_MERGED, "group 2 never ran merged after its erasure heal")
        # (c) SIGKILL group 2; restart it on the donor path with group 0's
        # link paced, and SIGKILL group 0 in the middle of the fetch.
        events["kill_c"] = kill((2, 2))
        write("hold_3", top_step() + 2)
        # Paced only once held: the survivors' own re-fetch after the kill
        # (a failed vote re-heals both) must not trip the signal.
        wait(lambda: all(os.path.exists(os.path.join(run_dir, f"held_3_g{g}"))
                         for g in (0, 1)), "groups 0 and 1 never held for group 2")
        write("pace_g0", int(HEAL_PACE_MBPS))
        start(2, 3, {})
        wait(lambda: os.path.exists(os.path.join(run_dir, "serving_g0")),
             "group 0 never streamed a stripe to group 2's third incarnation")
        time.sleep(HEAL_KILL_DELAY_S)
        events["kill_donor"] = kill((0, 0))
        wait(lambda: len([r for r in merged_commits((2, 3)) if r["participants"] == 2])
             >= HEAL_MERGED, "groups 1 and 2 never ran merged after the failover")
        write("stop", top_step() + 1)
        for key in ((1, 0), (2, 3)):
            rc = procs[key].wait(timeout=HEAL_TIMEOUT_S)
            readers[key].join(timeout=30)
            if rc != 0:
                raise RuntimeError(f"heal group {key} exited with {rc}")
        streams = {key: report.read_events([metrics_path(*key)]) for key in procs}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        lighthouse.shutdown()
        shutil.rmtree(run_dir, ignore_errors=True)
    phase_s = time.monotonic() - t_phase
    return heal_checks(card, recs, streams, events, phase_s, device, beside)


def heal_checks(card: str, recs: dict, streams: dict, events: dict, phase_s: float,
                device: str, beside: str) -> dict:
    """Phase 11's assertions and prints; returns the K1-K5 launches of all
    its processes and the seconds from each SIGKILL of group 2 to its
    restart's first merged commit (under "beside", what ran meanwhile)."""
    card = f"{card}; taken beside {beside}"
    cfg, _, _ = cut_config(HEAL_LAYERS)
    per_step = {"flash_fwd": cfg.n_layers, "flash_bwd_dkdv": cfg.n_layers,
                "flash_bwd_dq": cfg.n_layers, "ce_lse": 1, "ce_dlogits": 1}
    kinds = ("full", "chunk", "header", "metadata")

    def evs(key, name):
        return [e for e in streams[key] if e["event"] == name]

    def first_merged(key, n: int, after: float = 0.0):
        return next(r for r in recs[key] if r["committed"] and r["participants"] == n
                    and r["t"] > after)

    # Every process: K1-K5 launch per step, losses finite (asserted in the
    # group), peak memory.
    launches = {name: 0 for name in per_step}
    for key, rs in sorted(recs.items()):
        if not rs:
            raise AssertionError(f"heal group {key} printed no step")
        last = rs[-1]
        for r in rs:
            for name, k in per_step.items():
                if device == "cuda" and r["launches"].get(name) != k * r["steps_run"]:
                    raise AssertionError(f"heal group {key}: {name} launched "
                                         f"{r['launches'].get(name)} times in "
                                         f"{r['steps_run']} steps, expected {k} a step")
        for name in per_step:
            launches[name] += last["launches"].get(name, 0)
        print(f"  group {key[0]} incarnation {key[1]}: {last['steps_run']} steps, to step "
              f"{last['step']}; peak device memory {max(r['peak_mem'] for r in rs) / 2**30:.2f} "
              f"GiB; serving windows opened {last['windows']}, served {last['served']} ({card})",
              flush=True)
    # One params_sha256 per merged step, and every event's merged steps seen.
    by_step: dict = {}
    for key, rs in recs.items():
        for r in rs:
            if r["committed"] and r["participants"] >= 2:
                by_step.setdefault(r["step"], {})[key] = r["sha"]
    for step, shas in sorted(by_step.items()):
        if len(set(shas.values())) != 1:
            raise AssertionError(f"step {step}: params_sha256 differ across groups: {shas}")
    for key, n in (((2, 1), 3), ((2, 2), 3), ((2, 3), 2)):
        r = first_merged(key, n)
        together = by_step[r["step"]]
        if len(together) < n:
            raise AssertionError(f"step {r['step']}: {n} groups should have committed it "
                                 f"together, saw {sorted(together)}")
        print(f"  step {r['step']}: groups {sorted(together)} committed it merged with one "
              f"params_sha256 {r['sha'][:16]}...", flush=True)

    # (a) The striped two-donor heal, checksummed.
    fa = recs[(2, 1)][0].get("fetch") or {}
    if not (fa.get("mode") == "striped" and fa.get("n_donors") == 2
            and len(fa.get("by_donor", [])) == 2 and min(fa["by_donor"]) > 0
            and fa.get("crc_verified", 0) > 0 and not fa.get("dead")):
        raise AssertionError(f"(a) the heal was not striped over two live donors: {fa}")
    if evs((2, 1), "ec_reconstruct"):
        raise AssertionError("(a) the striped heal fell back to the erasure shards")
    modes = recs[(2, 1)][0].get("modes")
    if not modes:
        raise AssertionError("(a) the healer did not time the three fetch modes")
    print(f"  (a) striped heal: {fa['bytes'] / 1e9:.3f} GB from 2 donors, {fa['n_stripes']} "
          f"stripes ({fa['by_donor']} a donor) over {fa['workers']} workers in "
          f"{fa['fetch_s']} s = {fa['bytes'] / 1e9 / fa['fetch_s']:.3f} GB/s; "
          f"{fa['crc_verified']} buffers checksum-verified ({fa['crc_ms']} ms) ({card})",
          flush=True)
    for name, m in modes.items():
        print(f"  (a) same state, {name}: {m['fetch_s']:.3f} s, {m['gb_per_s']:.3f} GB/s "
              f"({m['n_donors']} donor(s), {m['n_stripes']} stripes, {m['workers']} workers; "
              f"checksums {m['crc_ms']} ms) ({card})", flush=True)
    stamps = [(e.get("crc_ms"), e.get("bytes")) for key in ((0, 0), (1, 0))
              for e in streams[key] if e["event"] == "span" and e["phase"] == "snapshot"
              and e.get("crc_ms") is not None]
    if not stamps:
        raise AssertionError("no snapshot span carries its checksum time")
    crc_ms = sorted(ms for ms, _ in stamps)
    print(f"  checksum stamp of a {stamps[0][1] / 1e9:.3f} GB snapshot on the snapshotter: "
          f"median {crc_ms[len(crc_ms) // 2]:.1f} ms, {crc_ms[0]:.1f}-{crc_ms[-1]:.1f} ms over "
          f"{len(crc_ms)} snapshots ({card})", flush=True)
    pushes = [e for key in ((0, 0), (1, 0)) for e in evs(key, "ec_push") if "encode_ms" in e]
    if not pushes:
        raise AssertionError("the survivors never encoded a shard generation")
    enc = sorted(e["encode_ms"] for e in pushes)
    print(f"  ec encode (background, k 2 m 1): median {enc[len(enc) // 2]:.1f} ms, "
          f"{enc[0]:.1f}-{enc[-1]:.1f} ms over {len(enc)} generations; shard "
          f"{pushes[0]['shard_bytes'] / 1e9:.3f} GB; parity pushed "
          f"{sum(e['push_bytes'] for e in pushes) / 1e9:.3f} GB in all ({card})", flush=True)

    # (b) The erasure heal: no donor fetch, no checkpoint served.
    recon = evs((2, 2), "ec_reconstruct")
    if len(recon) != 1 or evs((2, 2), "heal_start") or recs[(2, 2)][0].get("fetch"):
        raise AssertionError(f"(b) expected one erasure reconstruction and no donor fetch: "
                             f"{recon}, heal_start {evs((2, 2), 'heal_start')}")
    rb = first_merged((2, 2), 3)
    for key in ((0, 0), (1, 0)):
        # From the survivors' last step before group 2's request to the
        # step it first committed merged.
        before = [r for r in recs[key] if r["t"] <= events["join_b"]][-1]["served"]
        after = next(r for r in recs[key] if r["step"] == rb["step"])["served"]
        if any(before.get(k, 0) != after.get(k, 0) for k in kinds):
            raise AssertionError(f"(b) group {key[0]} served checkpoint requests during the "
                                 f"erasure heal: {before} -> {after}")
    print(f"  (b) ec_reconstruct of step {recon[0]['step']}: {recon[0]['reconstruct_ms']:.1f} "
          f"ms, shards {recon[0].get('shards_used')} ({recon[0].get('parity_used')} parity) "
          f"from {recon[0].get('holders')} holders; the donors served no checkpoint request "
          f"({card})", flush=True)

    # (c) The failover heal.
    fc = recs[(2, 3)][0].get("fetch") or {}
    if not (fc.get("mode") == "striped" and fc.get("n_donors") == 2
            and fc.get("failovers", 0) >= 1 and len(fc.get("dead", [])) == 1):
        raise AssertionError(f"(c) the heal did not fail a dead donor's stripes over: {fc}")
    if evs((2, 3), "ec_reconstruct"):
        raise AssertionError("(c) the donor heal fell back to the erasure shards")
    print(f"  (c) failover heal: {fc['fetch_s']} s for {fc['bytes'] / 1e9:.3f} GB; stripes a "
          f"donor {fc['by_donor']}, {fc['failovers']} failed over from {fc['dead']} "
          f"(group 0 paced to {HEAL_PACE_MBPS:.0f} MB/s, SIGKILLed "
          f"{HEAL_KILL_DELAY_S:.1f} s into its first stripe) ({card})", flush=True)

    recovery = {}
    for name, key, n in (("kill_b", (2, 2), 3), ("kill_c", (2, 3), 2),
                         ("kill_donor", (2, 3), 2)):
        r = first_merged(key, n, after=events[name])
        recovery[name] = r["t"] - events[name]
        print(f"  {name}: SIGKILL -> group 2's first merged commit {recovery[name]:.3f} "
              f"s ({card})", flush=True)
    print(f"  healing phase: {phase_s:.1f} s ({card})", flush=True)
    print("HEALING " + json.dumps({"modes": modes, "striped": fa, "failover": fc,
                                   "reconstruct": recon[0], "encode_ms": enc,
                                   "crc_stamp_ms": crc_ms, "phase_s": phase_s,
                                   "beside": beside}), flush=True)
    recovery["http_striped"] = {k: modes["striped"][k] for k in ("fetch_s", "gb_per_s", "bytes")}
    recovery["beside"] = recovery["http_striped"]["beside"] = beside
    return launches, recovery


# -- phase 12: the elastic plane on the flagship -----------------------------------

# The elastic path's depth: the flagship's width at half its 12 layers, cut
# so that phase 16 fits the run's time.
ELASTIC_LAYERS = 6
ELASTIC_GLOBAL_BATCH = 48  # 16 a group at 3 participants, 16 + 8 at 2
ELASTIC_MICROBATCH = 16
ELASTIC_MERGED = 2         # merged commits of every group before each event
ELASTIC_TIMEOUT_S = 420.0
ELASTIC_DRAIN_DEADLINE_S = 60.0
ELASTIC_KILL_DELAY_S = 0.3  # from group 1's step start to its SIGKILL
# (c) the straggler: group 0 sleeps this much more in every step, in the
# busy part (after the backward, before the averager).  With the busy-time
# EWMA's alpha of 0.5 the victim's ratio to the median reaches 1.5 at its
# second slow step wherever a step's busy time (three processes' compute
# on one card, and the step's parameter sha256) is under 3 s.
STRAGGLE_SLEEP_S = 2.0
# The sentinel's knobs, read by the embedded lighthouse at its construction;
# the lighthouse does not drain by itself (the launcher's sentinel does);
# the watcher's flap guard spans a second; and the goodput-floor trigger is
# held off: a dip recorded at the straggler alert's step would open that
# step's bundle first (first evidence wins), and the bundle's verdict would
# be the dip's.  The slow-link sentinel is held off too: the straggler's
# inbound links read as degraded, and the lighthouse raises no straggler
# alert for a replica that an active slow-link alert names.
ELASTIC_LIGHTHOUSE_ENV = {"TPUFT_STRAGGLER_RATIO": "1.5", "TPUFT_STRAGGLER_GRACE_STEPS": "3",
                          "TPUFT_STRAGGLER_AUTO_DRAIN": "0", "TPUFT_WATCHER_DEBOUNCE_S": "1",
                          "TPUFT_GOODPUT_WARMUP_OBS": "1000000",
                          "TPUFT_LINK_GRACE_STEPS": "1000000"}


def run_elastic_group(args: argparse.Namespace) -> None:
    """One replica group of the elastic phase, as the launcher starts it:
    the flagship built from its seed, then ``replica_env()`` (a hot spare
    starts the card and loads the kernels, then blocks there for its group
    id), then the examples' Manager (``make_manager``: the drain watcher
    attached).  Each step reads the Manager's elastic plan after its quorum
    and accumulates ``accum_steps`` microsteps of at most
    ``ELASTIC_MICROBATCH`` sequences that sum to the group's share of the
    global batch.  It leaves at a drain (``DRAIN exit``) or at the step in
    the run directory's ``stop`` file (``FINAL``).  Every step prints a
    STEP record: the group, the incarnation's replica id, the plan, the
    microsteps so far, the kernels' launch counts, the ring's configuration
    and the parameters' sha256."""
    import logging

    import torch

    from torchft_tpu_torch import GradientAverager
    from torchft_tpu_torch.examples._common import (
        TrainGate,
        make_manager,
        maybe_straggle,
        replica_env,
    )
    from torchft_tpu_torch.models import Transformer, loss_fn, resolve_device
    from torchft_tpu_torch.ops import launch_counts, reset_launch_counts

    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format=f"[e{os.getpid()}] %(message)s")
    cfg, _, seq = cut_config(ELASTIC_LAYERS)
    dev = resolve_device(args.device)
    # Group-independent: one seed for every group, paid by a spare while idle.
    model = Transformer(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(4000))
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    group, _ = replica_env(dev)
    manager = make_manager(
        lambda: {"model": model.state_dict(), "optim": opt.state_dict()},
        lambda sd: (model.load_state_dict(sd["model"]), opt.load_state_dict(sd["optim"])),
        group, min_replicas=1, timeout_s=180.0, init_sync=False)
    if not manager.worker_metrics.serving:
        raise AssertionError(f"elastic group {group}: the worker /metrics endpoint is not serving")
    print(f"WORKER_METRICS group {group} port {manager.worker_metrics.port}", flush=True)
    scrape = None
    averager = GradientAverager(manager)
    params = [p for p in model.parameters() if p.requires_grad]
    data = torch.Generator(device=dev).manual_seed(500 + group)
    gate = TrainGate(manager, steps=1 << 30)
    stop_path = os.path.join(args.run_dir, "stop")
    reset_launch_counts()
    microsteps = steps_run = 0
    while gate.should_continue():
        stop = _read_int(stop_path)
        if stop is not None and manager.current_step() >= stop:
            break
        if steps_run > 400:
            raise RuntimeError(f"elastic group {group}: never reached the stop step")
        before = manager.current_step()
        t0 = time.time()
        manager.start_quorum()
        manager.wait_quorum()
        plan = manager.elastic_plan()
        if plan is None or plan["global_batch"] != ELASTIC_GLOBAL_BATCH:
            raise RuntimeError(f"elastic group {group}: no elastic plan ({plan})")
        share, micro = plan["group_batch"], plan["microbatch"]
        # The step is in flight: its quorum has formed.
        print("BEGIN " + json.dumps({"rid": manager.replica_id(), "step": before,
                                     "t": time.time()}), flush=True)
        opt.zero_grad(set_to_none=True)
        loss_v, sizes = 0.0, []
        for m in range(plan["accum_steps"]):
            n = min(micro, share - m * micro)
            tokens = torch.randint(0, cfg.vocab_size, (n, seq), generator=data, device=dev)
            loss = loss_fn(model, {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)})
            (loss * (n / share)).backward()
            loss_v += float(loss) * n / share
            sizes.append(n)
        microsteps += len(sizes)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        # (c)'s injection point, outside every FT span (a no-op elsewhere).
        straggle_s = maybe_straggle(group)
        averager.allreduce([p.grad for p in params])
        committed = manager.should_commit()
        if committed:
            opt.step()
        gate.note_commit(committed)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        steps_run += 1
        # The worker endpoint after every step, across every reconfigure of
        # this incarnation: monotonic, lane totals equal to the ring's.
        scrape = worker_scrape(manager, scrape)
        col = manager.collective()
        rec = {"group": group, "rid": manager.replica_id(), "pid": os.getpid(), "before": before,
               "step": manager.current_step(), "committed": committed,
               "participants": manager.num_participants(), "plan": plan, "sizes": sizes,
               "microsteps": microsteps, "steps_run": steps_run, "loss": loss_v,
               "t0": t0, "t": time.time(), "launches": launch_counts(),
               "ring": [col.ring_engine, col.lanes, col.wire_dtype, col.size()],
               "configure": dict(col.last_configure), "straggle_s": straggle_s,
               "scrape": {k: scrape[k] for k in ("ms", "bytes", "hop_count")},
               "reconfigures": scrape["samples"].get(
                   f'tpuft_worker_reconfigures_total{{replica="{manager.replica_id()}"}}', 0.0),
               "peak_mem": torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0}
        if committed:
            flat = torch.cat([p.detach().reshape(-1).view(torch.uint8) for p in params])
            rec["sha"] = hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()
        print("STEP " + json.dumps(rec), flush=True)
        if committed and not math.isfinite(loss_v):
            raise RuntimeError(f"elastic group {group}: loss {loss_v} is not finite")
    if not gate.finish(group):
        print(f"[group {group}] FINAL step={manager.current_step()}", flush=True)
    manager.shutdown()


class _LogTail:
    """STEP records and lines of every log file in a directory, each line
    stamped with the host time a poll read it."""

    def __init__(self, run_dir: str) -> None:
        self._dir = run_dir
        self._pos: dict = {}
        self.recs: list = []
        self.begins: list = []
        self.lines: dict = {}

    def poll(self) -> None:
        for name in sorted(os.listdir(self._dir)):
            if not name.endswith(".log"):
                continue
            path = os.path.join(self._dir, name)
            with open(path, "rb") as f:
                f.seek(self._pos.get(name, 0))
                data = f.read()
            cut = data.rfind(b"\n") + 1
            self._pos[name] = self._pos.get(name, 0) + cut
            now = time.time()
            for line in data[:cut].decode(errors="replace").splitlines():
                self.lines.setdefault(name, []).append((now, line))
                if line.startswith("BEGIN "):
                    self.begins.append(json.loads(line[len("BEGIN "):]))
                if line.startswith("STEP "):
                    rec = json.loads(line[len("STEP "):])
                    rec["log"] = name
                    self.recs.append(rec)
                    short = {k: rec[k] for k in ("group", "step", "committed", "participants",
                                                 "microsteps")}
                    print(f"  [{name}] STEP {json.dumps(short)}", flush=True)

    def text(self, name: str) -> str:
        return "\n".join(line for _, line in self.lines.get(name, []))


def elastic_phase(card: str, cold: dict, device: str = "cuda") -> dict:
    """The flagship under the port's Launcher: three groups, one hot spare,
    the launcher's embedded lighthouse with the straggler sentinel and the
    incident watcher (dry-run), one metrics stream, the elastic engine at a
    global batch of 48.  (a) ``Launcher.drain(2)``: the donor finishes its
    step and exits, the spare adopts group 2 and heals.  (b) SIGKILL of
    group 1: the refilled spare adopts it and heals.  (c) Group 0 turns
    slow (a pid-pinned sleep in every step): the lighthouse's sentinel
    raises a straggler alert, the launcher rotates it out through a drain,
    the refilled spare adopts group 0 and heals, and the watcher bundles the
    alert and journals its recommendation.  ``cold`` holds the cold-restart
    seconds of phases 6 and 11 to print beside (b)'s.  Returns the K1-K5
    launches of every process."""
    from torchft_tpu_torch.launch import Launcher, fetch_alerts
    from torchft_tpu_torch.metrics import MetricsLogger
    from torchft_tpu_torch.obs import report

    run_dir = tempfile.mkdtemp(prefix="tpuft_elastic_")
    metrics_path = os.path.join(run_dir, "metrics.jsonl")
    fault_log = MetricsLogger(metrics_path, "chip_smoke")
    tail = _LogTail(run_dir)
    env = {"TPUFT_METRICS_PATH": metrics_path,
           "TPUFT_ELASTIC_GLOBAL_BATCH": str(ELASTIC_GLOBAL_BATCH),
           "TPUFT_ELASTIC_MICROBATCH": str(ELASTIC_MICROBATCH),
           "TPUFT_RING_ENGINE": "native", "TPUFT_STRAGGLE_DIR": run_dir, **WORKER_METRICS_ENV}
    prior = {k: os.environ.get(k) for k in ELASTIC_LIGHTHOUSE_ENV}
    os.environ.update(ELASTIC_LIGHTHOUSE_ENV)
    # A long straggler wait: a departure here is a drain or an evicted
    # SIGKILL, which no quorum waits for, so it holds back only a group
    # still finishing its heal step (a short one lets two groups re-form
    # without it while it heals, and it falls behind again).
    try:
        launcher = Launcher([sys.executable, os.path.abspath(__file__), "--elastic-group",
                             "--run-dir", run_dir, "--device", device],
                            num_groups=3, lighthouse="embed", min_replicas=2,
                            join_timeout_ms=60000, max_restarts=2, log_dir=run_dir, env=env,
                            cwd=HERE, spares=1, straggler_auto_drain=True,
                            incident_watcher=True, watcher_act=False)
    finally:
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    ev: dict = {}
    alerts: dict = {}
    last_alert_poll = [0.0]

    def victim_alerted(rid: str) -> bool:
        """Polls the lighthouse's alerts (5 a second) and keeps each active
        straggler alert the first time it is seen."""
        if time.monotonic() - last_alert_poll[0] >= 0.2:
            last_alert_poll[0] = time.monotonic()
            for a in (fetch_alerts(launcher.lighthouse_http_address) or {}).get("alerts", []):
                if a.get("kind") == "straggler" and a.get("active") and a["id"] not in alerts:
                    alerts[a["id"]] = dict(a, seen=time.time())
        return any(a["replica_id"] == rid for a in alerts.values())

    def wait(cond, what: str) -> None:
        deadline = time.monotonic() + ELASTIC_TIMEOUT_S
        while True:
            tail.poll()
            launcher.supervise_once()
            if cond():
                return
            if launcher.exhausted():
                raise RuntimeError(f"elastic phase: groups {launcher.exhausted()} died")
            if time.monotonic() > deadline:
                raise TimeoutError(f"elastic phase: {what}")
            time.sleep(0.02)

    def merged(rid_pred, n: int = 3, after: float = 0.0) -> list:
        return [r for r in tail.recs if rid_pred(r) and r["committed"]
                and r["participants"] == n and r["t"] > after]

    def rids(group: int) -> list:
        out = []
        for r in tail.recs:
            if r["group"] == group and r["rid"] not in out:
                out.append(r["rid"])
        return out

    def spare_ready() -> bool:
        return any(s.proc.poll() is None
                   and "[spare] ready" in tail.text(f"spare_{s.sid}.log")
                   for s in launcher._spares)

    try:
        launcher.start()
        wait(lambda: all(len(merged(lambda r, g=g: r["group"] == g)) >= ELASTIC_MERGED
                         for g in range(3)) and spare_ready(),
             "three groups never ran merged with a ready spare")
        # (a) Drain group 2 while its step is in flight (its quorum formed).
        donor_rid = rids(2)[0]
        n_begins = len(tail.begins)
        wait(lambda: any(b["rid"] == donor_rid for b in tail.begins[n_begins:]),
             "the donor never began a step")
        drain_spare = launcher._spares[0]
        ev["notice"] = time.time()
        fault_log.emit("fault", kind="drain", group="2")
        launcher.drain(2, deadline_s=ELASTIC_DRAIN_DEADLINE_S)
        ev["adopt_a"] = time.time()
        if launcher.pid(2) != drain_spare.proc.pid:
            raise AssertionError("the drained group's id did not go to the hot spare")
        wait(lambda: len(rids(2)) == 2 and not launcher.draining()
             and len(merged(lambda r: r["rid"] == rids(2)[1])) >= ELASTIC_MERGED
             and spare_ready(), "the drained group's replacement never ran merged")
        # (b) SIGKILL group 1 in the middle of a step (its quorum formed,
        # its microsteps running); the refilled spare adopts it.
        kill_spare = launcher._spares[0]
        n_begins = len(tail.begins)
        wait(lambda: any(b["rid"] == rids(1)[0] for b in tail.begins[n_begins:]),
             "group 1 never began a step")
        time.sleep(ELASTIC_KILL_DELAY_S)
        ev["kill"] = time.time()
        fault_log.emit("fault", kind="kill", group="1")
        launcher.kill(1, hold=False)
        if launcher.supervise_once() != [1] or launcher.pid(1) != kill_spare.proc.pid:
            raise AssertionError("the killed group's id did not go to the hot spare")
        ev["adopt_b"] = time.time()
        wait(lambda: len(rids(1)) == 2
             and len(merged(lambda r: r["rid"] == rids(1)[1])) >= ELASTIC_MERGED,
             "the killed group's replacement never ran merged")
        # (c) Group 0, which (a) and (b) left alone, turns slow: from now on
        # its incarnation sleeps STRAGGLE_SLEEP_S more in every step.
        wait(spare_ready, "the spare pool never refilled after (b)")
        victim_rid, victim_pid = rids(0)[0], launcher.pid(0)
        straggle_spare = launcher._spares[0]
        if len(rids(0)) != 1 or victim_pid is None:
            raise AssertionError(f"(c) group 0 is not its first incarnation: {rids(0)}")
        path = os.path.join(run_dir, "straggle_0.json")
        with open(path + ".tmp", "w", encoding="utf-8") as f:
            json.dump({"sleep_s": STRAGGLE_SLEEP_S, "pid": victim_pid}, f)
        os.replace(path + ".tmp", path)
        ev["inject"] = time.time()
        fault_log.emit("fault", kind="straggler", group="0")
        fault_log.emit("straggler_injected", group="0", sleep_s=STRAGGLE_SLEEP_S, pid=victim_pid)
        wait(lambda: victim_alerted(victim_rid), "the straggler was never alerted")
        wait(lambda: launcher.pid(0) not in (None, victim_pid),
             "the straggler was never rotated out")
        ev["adopt_c"] = time.time()
        if launcher.pid(0) != straggle_spare.proc.pid:
            raise AssertionError("(c) the straggler's slot did not go to the hot spare")
        wait(lambda: len(rids(0)) == 2 and not launcher.draining()
             and len(merged(lambda r: r["rid"] == rids(0)[1])) >= ELASTIC_MERGED,
             "the straggler's replacement never ran merged")
        with open(os.path.join(run_dir, "stop"), "w") as f:
            f.write(str(max(r["step"] for r in tail.recs) + 2))
        wait(lambda: all(launcher.pid(g) is None for g in range(3)),
             "the groups never stopped")
        # The last exit may land between the wait's supervise pass and its
        # check: one more pass records it.
        launcher.supervise_once()
        if not launcher.all_exited_clean():
            tail.poll()
            for g in range(3):
                print(f"  group {g}: exit code {launcher._groups[g].proc.returncode}",
                      flush=True)
            for name in sorted(tail.lines):
                for _, line in tail.lines[name][-15:]:
                    print(f"  [{name}] {line}", flush=True)
            raise AssertionError("a group exited non-zero at the stop step")
        tail.poll()
        flight = launcher._embedded.flight()
        events = report.read_events([metrics_path])
        logs = {name: tail.text(name) for name in tail.lines}
        restarts = launcher.restarts(1)
        # The watcher's journal and bundles live in the run directory.
        journal_path = os.path.join(run_dir, "watcher_journal.jsonl")
        with open(journal_path, encoding="utf-8") as f:
            journal = [json.loads(line) for line in f]
        bundles = {}
        for name in sorted(os.listdir(run_dir)):
            if name.startswith("incident_"):
                with open(os.path.join(run_dir, name, "incident.json"), encoding="utf-8") as f:
                    bundles[name] = json.load(f)
    finally:
        launcher.stop()
        fault_log.close()
        shutil.rmtree(run_dir, ignore_errors=True)
    ev["spares"] = (drain_spare.sid, kill_spare.sid, straggle_spare.sid)
    ev["restarts_1"] = restarts
    ev["victim"] = {"rid": victim_rid, "pid": victim_pid}
    ev["alerts"] = list(alerts.values())
    return elastic_checks(card, cold, tail.recs, events, flight, logs, ev, donor_rid, device,
                          journal, bundles)


def elastic_checks(card: str, cold: dict, recs: list, events: list, flight: dict, logs: dict,
                   ev: dict, donor_rid: str, device: str, journal: list, bundles: dict) -> dict:
    """Phase 12's assertions and prints; returns the K1-K5 launches of all
    its processes."""
    from torchft_tpu_torch.obs import report

    cfg, _, _ = cut_config(ELASTIC_LAYERS)
    per_micro = {"flash_fwd": cfg.n_layers, "flash_bwd_dkdv": cfg.n_layers,
                 "flash_bwd_dq": cfg.n_layers, "ce_lse": 1, "ce_dlogits": 1}
    by_rid: dict = {}
    for r in recs:
        by_rid.setdefault(r["rid"], []).append(r)
    # Incarnations in the order they first stepped.
    order = sorted(by_rid, key=lambda rid: by_rid[rid][0]["t"])
    repl_a = [rid for rid in order if by_rid[rid][0]["group"] == 2][1]
    repl_b = [rid for rid in order if by_rid[rid][0]["group"] == 1][1]
    victim = ev["victim"]["rid"]
    repl_c = [rid for rid in order if by_rid[rid][0]["group"] == 0][1]
    survivors_a = [rid for rid in order if by_rid[rid][0]["group"] in (0, 1)
                   and by_rid[rid][0]["t"] < ev["kill"]]

    # Every process: K1-K5 per microstep, the native 2-lane ring on the f32
    # wire, peak memory.
    launches = {name: 0 for name in per_micro}
    for rid, rs in by_rid.items():
        for r in rs:
            for name, k in per_micro.items():
                if device == "cuda" and r["launches"].get(name) != k * r["microsteps"]:
                    raise AssertionError(f"elastic {rid}: {name} launched "
                                         f"{r['launches'].get(name)} times in "
                                         f"{r['microsteps']} microsteps, expected {k} each")
            if r["committed"] and r["ring"][3] > 1 and r["ring"][:3] != ["native", 2, "f32"]:
                raise AssertionError(f"elastic {rid}: the ring ran {r['ring']}")
        for name in per_micro:
            launches[name] += rs[-1]["launches"].get(name, 0)
        print(f"  group {rs[0]['group']} ({rid[:12]}, pid {rs[0]['pid']}, {rs[0]['log']}): "
              f"{rs[-1]['steps_run']} steps, {rs[-1]['microsteps']} microsteps, to step "
              f"{rs[-1]['step']}; peak device memory "
              f"{max(r['peak_mem'] for r in rs) / 2**30:.2f} GiB ({card})", flush=True)

    # One params_sha256 per merged step.
    by_step: dict = {}
    for r in recs:
        if r["committed"] and r["participants"] >= 2:
            by_step.setdefault(r["step"], {})[r["rid"]] = r["sha"]
    for step, shas in sorted(by_step.items()):
        if len(set(shas.values())) != 1:
            raise AssertionError(f"step {step}: params_sha256 differ: {shas}")
    last = max(s for s, shas in by_step.items() if len(shas) == 3)
    print(f"  step {last}: all three groups committed it merged with one params_sha256 "
          f"{next(iter(by_step[last].values()))[:16]}...", flush=True)

    # (a) The donor: its step in flight at the notice committed, it left
    # through complete_drain with its marker and exit 0.
    donor = by_rid[donor_rid]
    in_flight = next(r for r in donor if r["t"] >= ev["notice"])
    if not in_flight["committed"]:
        raise AssertionError(f"(a) the donor's step in flight did not commit: {in_flight}")
    donor_log = logs[donor[0]["log"]]
    if "DRAIN exit" not in donor_log or "drain complete at step" not in donor_log:
        raise AssertionError("(a) the donor printed no drain marker")
    exits = [e for e in events if e["event"] == "drain_donor_exit"]
    handoffs = [e for e in events if e["event"] == "drain_handoff"]
    if ([(e["group"], e["exit_code"]) for e in exits] != [("2", 0), ("0", 0)]
            or [(e["group"], e["hot_spare"]) for e in handoffs] != [("2", True), ("0", True)]):
        raise AssertionError(f"(a), (c) donor exits {exits}, handoffs {handoffs}")
    # The lighthouse's first quorum after the drain mark leaves the donor out.
    flights = sorted(flight.get("events", []), key=lambda e: e["seq"])
    mark = next(e["seq"] for e in flights if e["kind"] == "replica_drain"
                and e["detail"].startswith(("prefix=2 ", f"prefix={donor_rid} ")))
    nxt = next(e for e in flights if e["kind"] == "quorum_formed" and e["seq"] > mark)
    members = nxt["detail"].split("members=[", 1)[1].split("]", 1)[0].split(",")
    if donor_rid in members:
        raise AssertionError(f"(a) the quorum after the drain lists the donor: {nxt['detail']}")
    # No survivor failed a commit from the first three-way merge to the kill.
    t_start = min(r["t"] for r in recs if r["committed"] and r["participants"] == 3)
    failed = [r for rid in survivors_a for r in by_rid[rid]
              if not r["committed"] and t_start <= r["t"] <= ev["kill"]]
    if failed:
        raise AssertionError(f"(a) survivors failed commits: {failed}")
    # The elastic records: 48 on every committed summary, the survivors'
    # participants 3 -> 2 -> 3 through (a), 2 microsteps (16 + 8) at 2.
    summaries = [e for e in events if e["event"] == "step_summary" and e.get("committed")]
    if not summaries or any(e.get("elastic_global_batch") != ELASTIC_GLOBAL_BATCH
                            for e in summaries):
        raise AssertionError("a committed step_summary lacks elastic_global_batch 48")
    for rid in survivors_a:
        seen = [e["elastic_participants"] for e in summaries if e["replica_id"] == rid
                and t_start <= e["ts"] <= ev["kill"]]
        runs = [k for k, _ in itertools.groupby(seen)]
        if runs[-3:] != [3, 2, 3] or runs.count(2) != 1:
            raise AssertionError(f"(a) {rid}: elastic_participants ran {runs}, not 3 -> 2 -> 3")
        at2 = [r for r in by_rid[rid] if r["committed"] and r["participants"] == 2
               and r["t"] <= ev["kill"]]
        if not at2 or any(r["sizes"] != [16, 8] for r in at2):
            raise AssertionError(f"(a) {rid}: steps at 2 participants ran "
                                 f"{[r['sizes'] for r in at2]}, not [16, 8]")
    # The 0 <-> 1 edge survives every reconfigure of (a) on both its ends.
    recfg = [e for e in events if e["event"] == "reconfigure" and e["replica_id"] in survivors_a
             and ev["notice"] <= e["ts"] <= ev["kill"]]
    if not recfg or any(e["mode"] != "incremental" or e["reused_lanes"] < 2 for e in recfg):
        raise AssertionError(f"(a) survivors' reconfigures: "
                             f"{[(e['mode'], e['reused_lanes']) for e in recfg]}")
    # The replacement is the adopted spare, and it healed.
    spare_log = logs[f"spare_{ev['spares'][0]}.log"]
    if ("adopted replica group 2" not in spare_log or "healing from replica" not in spare_log
            or by_rid[repl_a][0]["log"] != f"spare_{ev['spares'][0]}.log"):
        raise AssertionError("(a) the replacement is not the adopted, healed spare")

    # (b) One adoption after the SIGKILL, and a heal.
    spare_log = logs[f"spare_{ev['spares'][1]}.log"]
    if (spare_log.count("adopted replica group") != 1 or "adopted replica group 1" not in spare_log
            or "healing from replica" not in spare_log or ev["restarts_1"] != 1):
        raise AssertionError("(b) the killed group was not restarted once by the adopted spare")

    # (c) The straggler: an active straggler alert named group 0's
    # incarnation; the launcher's sentinel emitted one straggler_drain, for
    # it; the refilled spare adopted group 0 and healed; the sleep stayed
    # with the victim's pid; no survivor failed a commit; the watcher
    # journaled a dry-run drain of group 0 and bundled a verdict naming it.
    alert = next((a for a in ev["alerts"] if a["replica_id"] == victim), None)
    if alert is None:
        raise AssertionError(f"(c) no active straggler alert named {victim}: {ev['alerts']}")
    sd = [e for e in events if e["event"] == "straggler_drain"]
    if [(e["group"], e["replica_id"]) for e in sd] != [("0", victim)]:
        raise AssertionError(f"(c) straggler_drain events {sd}, expected one for {victim}")
    spare_log = logs[f"spare_{ev['spares'][2]}.log"]
    if ("adopted replica group 0" not in spare_log or "healing from replica" not in spare_log
            or by_rid[repl_c][0]["log"] != f"spare_{ev['spares'][2]}.log"):
        raise AssertionError("(c) the straggler's replacement is not the adopted, healed spare")
    slept = sorted({r["straggle_s"] for r in by_rid[victim] if r["t0"] >= ev["inject"]})
    if slept != [STRAGGLE_SLEEP_S] or any(r["straggle_s"] for r in by_rid[victim]
                                          if r["t"] < ev["inject"]):
        raise AssertionError(f"(c) the victim's sleeps {slept}")
    if any(r["straggle_s"] for r in by_rid[repl_c]):
        raise AssertionError("(c) the sleep followed the slot to the replacement")
    survivors_c = [repl_a, repl_b]  # groups 2 and 1 since (a) and (b)
    failed = [r for rid in survivors_c for r in by_rid[rid]
              if not r["committed"] and r["t"] >= ev["inject"]]
    if failed:
        raise AssertionError(f"(c) survivors failed commits: {failed}")
    if len([r for r in by_rid[repl_c] if r["committed"] and r["participants"] == 3]) < \
            ELASTIC_MERGED:
        raise AssertionError("(c) the replacement ran fewer than ELASTIC_MERGED merged commits")
    entries = [e for e in journal if e["kind"] == "straggler"]
    if not any(e["policy"] == "drain" and e["acted"] is False and e["target"] == "0"
               for e in entries):
        raise AssertionError(f"(c) the watcher journaled no dry-run drain of group 0: {journal}")
    named = [b for b, m in bundles.items() if (m.get("verdict") or {}).get("kind") == "straggler"
             and m["verdict"].get("replica") == "0"]
    if not named:
        raise AssertionError(f"(c) no bundle's verdict names group 0: "
                             f"{ {b: m.get('verdict', {}).get('kind') for b, m in bundles.items()} }")
    print(f"  (c) watcher journal: " + "; ".join(
        f"{e['kind']} -> {e['policy']} {e['target']} (acted {e['acted']}, {e['bundle']})"
        for e in journal) + f"; bundles {sorted(bundles)}; {named[0]}'s verdict "
        f"{json.dumps({k: v for k, v in bundles[named[0]]['verdict'].items() if k != 'incident'})}",
        flush=True)

    # Every step scraped its worker endpoint (monotonic across the
    # incarnation's reconfigures, lane totals equal to the ring's).
    sc = sorted(r["scrape"]["ms"] for r in recs)
    print(f"  worker /metrics: {len(recs)} scrapes, median {sc[len(sc) // 2]:.2f} ms, max "
          f"{sc[-1]:.2f} ms, {max(r['scrape']['bytes'] for r in recs)} bytes at most; "
          + ", ".join(f"{rid[:12]} reconfigures {by_rid[rid][0]['reconfigures']:.0f} -> "
                      f"{by_rid[rid][-1]['reconfigures']:.0f}" for rid in order)
          + f" ({card})", flush=True)

    # Prints: each transition's dead time, configure mode and ms, the
    # drain's handoff, the adoptions' recovery.
    commits = report.commit_timelines(events)
    for name, t_fault, group, repl in (("(a) drain", ev["notice"], "2", repl_a),
                                       ("(b) SIGKILL", ev["kill"], "1", repl_b)):
        dw = report.deadwindow(commits, [(t_fault, group)])
        first = min(r["t"] for r in by_rid[repl] if r["committed"])
        first_merged = min(r["t"] for r in by_rid[repl] if r["committed"]
                           and r["participants"] == 3)
        cfgs = [(e["replica_id"].split(":")[0], e["mode"], e["reused_lanes"],
                 round(e["configure_ms"], 1)) for e in events if e["event"] == "reconfigure"
                and t_fault <= e["ts"] <= first_merged + 1.0]
        print(f"  {name} of group {group}: obs.report.deadwindow dead time "
              f"{dw['dead_time_s']:.3f} s; fault -> replacement's first commit "
              f"{first - t_fault:.3f} s, first merged commit {first_merged - t_fault:.3f} s; "
              f"adoption -> first merged commit "
              f"{first_merged - ev['adopt_a' if group == '2' else 'adopt_b']:.3f} s; "
              f"reconfigures (group, mode, reused lanes, ms) {cfgs} ({card})", flush=True)
        ev[f"dead_{group}"] = dw["dead_time_s"]
        ev[f"merged_{group}"] = first_merged - t_fault
    old = sorted(r["t"] for r in donor if r["committed"])
    new = sorted(r["t"] for r in by_rid[repl_a] if r["committed"])
    steps_iv = sorted(b - a for a, b in zip(old, old[1:]))
    gap = new[0] - old[-1]
    print(f"  (a) donor's last commit -> replacement's first: {gap:.3f} s, less a median "
          f"step {steps_iv[len(steps_iv) // 2]:.3f} s: "
          f"{max(0.0, gap - steps_iv[len(steps_iv) // 2]):.3f} s; drain notice -> donor "
          f"exit {exits[0]['drain_s']:.3f} s ({card})", flush=True)
    print(f"  (b) SIGKILL -> hot spare's first merged commit {ev['merged_1']:.3f} s, beside "
          f"the cold restarts of this run: phase 11 "
          f"{', '.join(f'{v:.3f}' for v in cold.get('heal', []))} s (flagship, taken beside "
          f"{cold.get('heal_beside')}), phase 6 "
          f"{cold.get('kill_heal', float('nan')):.3f} s (conv net) ({card})", flush=True)
    # (c)'s timeline.
    raised = alert["raised_ms"] / 1e3
    to_alert = [r for r in by_rid[victim] if r["t0"] >= ev["inject"] and r["t"] <= raised]
    drain_ts = sd[0]["ts"]
    exit_c = next(e for e in exits if e["group"] == "0")
    handoff_c = next(e for e in handoffs if e["group"] == "0")
    first_merged_c = min(r["t"] for r in by_rid[repl_c] if r["committed"]
                         and r["participants"] == 3)

    def med(xs: list) -> float:
        return sorted(xs)[len(xs) // 2] if xs else float("nan")

    def walls(lo: float, hi: float) -> list:
        """The survivors' merged steps at three participants in [lo, hi]."""
        return [r["t"] - r["t0"] for rid in survivors_c for r in by_rid[rid]
                if r["committed"] and r["participants"] == 3 and lo <= r["t0"] and r["t"] <= hi]

    first_merged_b = min(r["t"] for r in by_rid[repl_b] if r["committed"]
                         and r["participants"] == 3)
    w_before = walls(first_merged_b, ev["inject"])
    w_during = walls(ev["inject"], drain_ts)
    w_after = walls(first_merged_c, float("inf"))
    dw = report.deadwindow(commits, [(ev["inject"], "0")])
    busy = [(e["ts"], e.get("step_time_ms_ewma")) for e in events
            if e["event"] == "step_summary" and e["replica_id"] == victim and e.get("committed")]
    busy_before = [b for ts, b in busy if ts < ev["inject"]]
    busy_during = [b for ts, b in busy if ts >= ev["inject"]]
    print(f"  (c) straggler of group 0 ({victim[:12]}, {STRAGGLE_SLEEP_S} s a step): injection -> "
          f"alert {raised - ev['inject']:.3f} s, {len(to_alert)} of its steps (ratio "
          f"{alert.get('ratio')}, step time {alert.get('step_time_ms')} ms; busy EWMA "
          f"{busy_before[-1] if busy_before else None} ms before, "
          f"{max(busy_during) if busy_during else None} ms at most after); alert -> "
          f"straggler_drain {drain_ts - raised:.3f} s; drain notice -> donor exit "
          f"{exit_c['drain_s']:.3f} s; adoption -> first merged commit "
          f"{first_merged_c - handoff_c['ts']:.3f} s; merged step wall (median) before "
          f"{med(w_before):.3f} s ({len(w_before)}), during the straggle {med(w_during):.3f} s "
          f"({len(w_during)}), after the rotation {med(w_after):.3f} s ({len(w_after)}); "
          f"obs.report.deadwindow dead time {dw['dead_time_s']:.3f} s ({card})", flush=True)
    ev.update({"alert_s": raised - ev["inject"], "alert_steps": len(to_alert),
               "alert_to_drain_s": drain_ts - raised, "donor_exit_c_s": exit_c["drain_s"],
               "adopt_to_merged_c_s": first_merged_c - handoff_c["ts"],
               "wall_before_s": med(w_before), "wall_during_s": med(w_during),
               "wall_after_s": med(w_after), "dead_0": dw["dead_time_s"]})
    print("ELASTIC " + json.dumps({k: v for k, v in ev.items() if k not in ("spares",)}),
          flush=True)
    return launches


# -- phase 13: durable state and isolated communication on the flagship -----------

# The durable path's depth: the flagship's width at a quarter of its 12
# layers, cut so that phase 16 fits the run's time.
DURABLE_LAYERS = 3
DURABLE_STEPS = 4           # N: run (a)'s merged steps; (b) stops at N / 2 and resumes to N
DURABLE_EVERY = 2           # ManagedDiskCheckpoint(every=, keep=) of (b)
DURABLE_KEEP = 2
DURABLE_MERGED = 2          # merged commits in (c) and (d) before each event and at the end
DURABLE_ROWS = 2048         # rows of the seeded host token table, seq + 1 tokens each
DURABLE_BATCH = 16          # a group's batch (the flagship's)
DURABLE_TIMEOUT_S = 420.0
DURABLE_BABY_TIMEOUT_S = 120.0   # the baby collective's configure and op deadline
DURABLE_HEARTBEAT_MS = 2000      # the phase's lighthouse declares a silent group dead after
DURABLE_SOLO_PAUSE_S = 0.5       # a group's pause after a step it ran alone


def state_digest(state) -> str:
    """sha256 of a state dict's serialized leaves (every tensor's bytes, in
    the port's flatten order, and every plain value)."""
    from torchft_tpu_torch.checkpointing.serialization import flatten_state_dict

    meta, buffers = flatten_state_dict(state)
    h = hashlib.sha256()
    for kind, value in meta.leaves:
        if kind == "tensor":
            h.update(repr(meta.tensors[value]).encode())
            h.update(memoryview(buffers[value]))
        else:
            h.update(repr(value).encode())
    return h.hexdigest()


def run_durable_group(args: argparse.Namespace) -> None:
    """One replica group of phase 13: the flagship (one seed for both
    groups, so no step-0 sync) drawing its batches through a
    ``StatefulDataLoader`` over a seeded host token table, its state the
    model's, AdamW's and the loader's.  Its Manager gets a
    ``CollectiveTransport`` through ``set_checkpoint_transport`` and prints
    every membership callback.  ``cfg_<g>_<k>.json`` in the run directory
    sets the incarnation: ``ckpt_dir`` (a ``ManagedDiskCheckpoint``,
    restored before the first quorum), ``hold_at`` (stop there once that
    step's checkpoint is durable, print its digest and wait for the
    SIGKILL), ``baby`` (a ``BabyTCPCollective`` with ``max_retries=2``) and
    ``kill_child`` (SIGKILL the baby's child during an allreduce after
    DURABLE_MERGED merged commits).  Files steer it: ``go_<k>`` (the first
    quorum, once the parent saw every ``ready_<g>_<k>``), ``ckpt_off``
    (saves stop) and ``stop`` (leave at that step)."""
    import logging
    import signal
    from datetime import timedelta

    import numpy as np
    import torch

    from torchft_tpu_torch.baby import BabyTCPCollective
    from torchft_tpu_torch.checkpointing import CollectiveTransport, ManagedDiskCheckpoint
    from torchft_tpu_torch.collectives import TCPCollective
    from torchft_tpu_torch.data import DistributedSampler, StatefulDataLoader
    from torchft_tpu_torch.manager import ExceededMaxRetriesError, Manager
    from torchft_tpu_torch.models import Transformer, loss_fn, resolve_device
    from torchft_tpu_torch.ops import launch_counts, reset_launch_counts
    from torchft_tpu_torch.parallel import TrainStep

    group, inc, run_dir = args.durable_group, args.incarnation, args.run_dir
    path = lambda name: os.path.join(run_dir, name)  # noqa: E731
    with open(path(f"cfg_{group}_{inc}.json")) as f:
        conf = json.load(f)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format=f"[d{group}.{inc}] %(message)s")
    # The collective first: a baby's forkserver then imports while the model
    # is built.
    baby = bool(conf.get("baby"))
    collective = (BabyTCPCollective(timeout=DURABLE_BABY_TIMEOUT_S, host="127.0.0.1") if baby
                  else TCPCollective(timeout=180.0, host="127.0.0.1"))
    cfg, _, seq = cut_config(DURABLE_LAYERS)
    dev = resolve_device(args.device)
    model = Transformer(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(4000))
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    table = np.random.default_rng(4100).integers(0, cfg.vocab_size, (DURABLE_ROWS, seq + 1),
                                                 dtype=np.int64)
    loader = StatefulDataLoader(DistributedSampler(DURABLE_ROWS, group, 2, shuffle=True,
                                                   seed=4200), batch_size=DURABLE_BATCH)
    batches = iter(loader)
    restored: dict = {}
    digest_next = [bool(conf.get("ckpt_dir"))]

    def save():
        return {"model": model.state_dict(), "optim": opt.state_dict(),
                "loader": loader.state_dict()}

    def load(sd) -> None:
        nonlocal batches
        if digest_next[0]:
            # The disk restore: the digest and placement of what came back.
            restored["digest"] = state_digest(sd)
            restored["model_devices"] = sorted({str(t.device) for t in sd["model"].values()})
        model.load_state_dict(sd["model"])
        opt.load_state_dict(sd["optim"])
        loader.load_state_dict(sd["loader"])
        batches = iter(loader)

    timeout = timedelta(seconds=180)
    manager = Manager(
        collective=collective, load_state_dict=load, state_dict=save, min_replica_size=1,
        rank=0, world_size=1, replica_id=f"durable_g{group}", lighthouse_addr=args.lighthouse,
        store_addr="127.0.0.1", manager_bind="127.0.0.1:0", timeout=timeout,
        quorum_timeout=timeout, init_sync=False, max_retries=2 if baby else None,
    )
    transport = CollectiveTransport(collective, timeout=180.0, state_dict_fn=save)
    manager.set_checkpoint_transport(transport)
    manager.register_membership_callback(
        lambda payload: print("MEMBERSHIP " + json.dumps(payload), flush=True))
    trainer = TrainStep(model, opt, loss_fn, manager)
    mdc = None
    if conf.get("ckpt_dir"):
        mdc = ManagedDiskCheckpoint(manager, save, load,
                                    os.path.join(conf["ckpt_dir"], f"group_{group}"),
                                    every=DURABLE_EVERY, keep=DURABLE_KEEP)
        t0 = time.time()
        step = mdc.restore()
        digest_next[0] = False
        if step is not None:
            print(f"[group {group}] resumed from disk checkpoint step={step}", flush=True)
            print("RESUMED " + json.dumps({"step": step, "t": time.time(), "restore_s":
                                           time.time() - t0, "loader": loader.state_dict(),
                                           "device": dev.type, **restored}), flush=True)
    open(path(f"ready_{group}_{inc}"), "w").close()
    deadline = time.monotonic() + DURABLE_TIMEOUT_S
    while not os.path.exists(path(f"go_{inc}")):
        if time.monotonic() > deadline:
            raise TimeoutError(f"durable group {group}: go_{inc} never appeared")
        time.sleep(0.02)

    def params_sha() -> str:
        h = hashlib.sha256()
        for name, p in model.state_dict().items():
            h.update(name.encode())
            h.update(p.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()
                     .tobytes())
        return h.hexdigest()

    def kill_child_in_flight() -> None:
        """Wraps the baby's allreduce once: the first bucket's op is
        submitted, then the child gets SIGKILL; the op's failure is timed
        from it."""
        allreduce = collective.allreduce

        def and_kill(*a, **kw):
            collective.allreduce = allreduce
            work = allreduce(*a, **kw)
            child = collective.child_pid()
            t_kill = time.time()
            os.kill(child, signal.SIGKILL)

            def failed(fut) -> None:
                print("OPFAIL " + json.dumps({"dt": time.time() - t_kill,
                                              "exc": repr(fut.exception())}), flush=True)

            work.add_done_callback(failed)
            print("CHILD_KILLED " + json.dumps({"child": child, "t": t_kill, "pid": os.getpid(),
                                                "step": manager.current_step()}), flush=True)
            return work

        collective.allreduce = and_kill

    reset_launch_counts()
    fetch = transport.last_fetch
    merged = steps_run = 0
    child_killed = False
    try:
        while True:
            step = manager.current_step()
            stop = _read_int(path("stop"))
            if stop is not None and step >= stop:
                break
            if steps_run > 2000:
                raise RuntimeError(f"durable group {group}: never reached the stop step")
            manager.start_quorum()
            if baby and conf.get("kill_child") and merged >= DURABLE_MERGED and not child_killed:
                kill_child_in_flight()
                child_killed = True
            rows = next(batches, None)
            if rows is None:  # the epoch ended: the next one starts
                batches = iter(loader)
                rows = next(batches)
            batch = torch.from_numpy(table[rows]).to(dev)
            t0 = time.perf_counter()
            try:
                loss, committed = trainer.ft_step({"tokens": batch[:, :-1].contiguous(),
                                                   "targets": batch[:, 1:].contiguous()})
            except ExceededMaxRetriesError as e:
                print("EXCEEDED " + json.dumps({"t": time.time(), "error": repr(e),
                                                "errored": repr(collective.errored()),
                                                "pid": os.getpid()}), flush=True)
                raise
            loss_v = float(loss)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            steps_run += 1
            rec = {"group": group, "inc": inc, "before": step, "step": manager.current_step(),
                   "committed": committed, "participants": manager.num_participants(),
                   "loss": loss_v, "step_s": step_s, "t": time.time(), "pid": os.getpid(),
                   "launches": launch_counts(), "loader": loader.state_dict(),
                   "errored": repr(collective.errored()) if collective.errored() else None,
                   "healed": manager.current_step() - step > 1,
                   "peak_mem": torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0}
            if baby:
                rec["configure"] = dict(collective.last_configure)
            if transport.last_fetch is not fetch:
                fetch = transport.last_fetch
                rec["fetch"] = dict(fetch)
            if committed:
                merged += manager.num_participants() == 2
                rec["sha"] = params_sha()
                if not math.isfinite(loss_v):
                    raise RuntimeError(f"durable group {group}: loss {loss_v} is not finite")
                if mdc is not None and not os.path.exists(path("ckpt_off")):
                    # The last save, its write done by now, then this step's.
                    rec["saves"] = [dict(mdc.checkpointer.last_save)]
                    t_save = time.perf_counter()
                    mdc.maybe_save(committed)
                    rec["save_call_ms"] = (time.perf_counter() - t_save) * 1e3
                    rec["saves"].append(dict(mdc.checkpointer.last_save))
            print("STEP " + json.dumps(rec), flush=True)
            if manager.num_participants() < 2:
                # Alone while the other group restarts: a slow pace, so the
                # survivor's steps do not crowd the card.
                time.sleep(DURABLE_SOLO_PAUSE_S)
            if committed and conf.get("hold_at") == manager.current_step():
                t0 = time.perf_counter()
                mdc.checkpointer.wait()
                print("DURABLE " + json.dumps({
                    "step": manager.current_step(), "wait_s": time.perf_counter() - t0,
                    "save": dict(mdc.checkpointer.last_save), "digest": state_digest(save()),
                    "loader": loader.state_dict(), "t": time.time()}), flush=True)
                while True:  # until the parent's SIGKILL
                    time.sleep(1.0)
    finally:
        if mdc is not None:
            mdc.shutdown()
        manager.shutdown()
    print("FINAL " + json.dumps({"group": group, "inc": inc, "step": manager.current_step(),
                                 "sha": params_sha()}), flush=True)


def durable_phase(card: str, http_striped: dict, device: str = "cuda") -> dict:
    """A lighthouse and two flagship groups: (a) DURABLE_STEPS merged steps
    without interruption (on a second lighthouse, beside (b)'s first
    incarnation); (b) the same schedule under ManagedDiskCheckpoint
    (every 2, keep 2), both groups SIGKILLed at N / 2 once that checkpoint is
    durable, a torn newer file and a stray .tmp planted in group 0's
    directory, both restarted from disk; (c) group 1 SIGKILLed, its
    directory deleted, restarted cold: it heals from group 0 over
    CollectiveTransport; (d) group 1 restarted on BabyTCPCollective, its
    child SIGKILLed during an allreduce, and after the reference's sequence
    (failed votes on both groups, ExceededMaxRetriesError) restarted once
    more.  Returns the K1-K5 launches of all its processes."""
    from torchft_tpu_torch._native import LighthouseServer
    from torchft_tpu_torch.obs import report

    n_params = flagship_param_count(cut_config(DURABLE_LAYERS)[0])
    state_bytes = 12 * n_params  # f32 weights and AdamW's two moments
    run_dir = tempfile.mkdtemp(prefix="tpuft_durable_")
    ckpt_dir = os.path.join(run_dir, "ckpt")
    # keep=2 files a group, a third in flight as .tmp, for two groups.
    need = 2 * (DURABLE_KEEP + 1) * state_bytes
    free = shutil.disk_usage(run_dir).free
    print(f"  disk: {free / 1e9:.1f} GB free under {run_dir}, {need / 1e9:.1f} GB needed "
          f"(2 groups x (keep {DURABLE_KEEP} + 1 in flight) x {state_bytes / 1e9:.3f} GB)",
          flush=True)
    if free < need:
        shutil.rmtree(run_dir, ignore_errors=True)
        raise RuntimeError(f"phase 13 needs {need / 1e9:.1f} GB free under {run_dir}, "
                           f"{free / 1e9:.1f} GB are")
    lighthouse, lighthouse_ref = (
        LighthouseServer(bind="127.0.0.1:0", http_bind="127.0.0.1:0", min_replicas=1,
                         join_timeout_ms=1000, heartbeat_timeout_ms=DURABLE_HEARTBEAT_MS)
        for _ in range(2))
    procs, recs, lines, starts = {}, {}, {}, {}
    lock = threading.Lock()
    expected_exit = set()
    N, half = DURABLE_STEPS, DURABLE_STEPS // 2

    def start(g: int, k: int, conf: dict, sync: bool, lh=None) -> None:
        with open(os.path.join(run_dir, f"cfg_{g}_{k}.json"), "w") as f:
            json.dump(conf, f)
        env = {**os.environ,
               "TPUFT_METRICS_PATH": os.path.join(run_dir, f"metrics_{g}_{k}.jsonl")}
        starts[(g, k)] = time.time()
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--durable-group", str(g),
             "--incarnation", str(k), "--lighthouse", (lh or lighthouse).address(), "--run-dir",
             run_dir, "--device", device], stdout=subprocess.PIPE, text=True, cwd=HERE, env=env)
        procs[(g, k)], recs[(g, k)], lines[(g, k)] = proc, [], []

        def read() -> None:
            for line in proc.stdout:
                line = line.rstrip("\n")
                head, _, body = line.partition(" ")
                with lock:
                    if head in ("STEP", "MEMBERSHIP", "RESUMED", "DURABLE", "CHILD_KILLED",
                                "OPFAIL", "EXCEEDED", "FINAL"):
                        lines[(g, k)].append((head, json.loads(body)))
                        if head == "STEP":
                            recs[(g, k)].append(json.loads(body))
                if head == "STEP":
                    rec = json.loads(body)
                    short = {x: rec.get(x) for x in ("step", "committed", "participants",
                                                     "loss", "step_s")}
                    print(f"  [d{g}.{k}] STEP {json.dumps(short)}", flush=True)
                elif head != "MEMBERSHIP":
                    print(f"  [d{g}.{k}] {line}", flush=True)

        threading.Thread(target=read, daemon=True).start()
        if not sync:
            write(f"go_{k}", 1)

    def write(name: str, value) -> None:
        tmp = os.path.join(run_dir, name + ".tmp")
        with open(tmp, "w") as f:
            f.write(str(value))
        os.replace(tmp, os.path.join(run_dir, name))

    def wait(cond, what: str) -> None:
        deadline = time.monotonic() + DURABLE_TIMEOUT_S
        while not cond():
            for key, p in procs.items():
                if p.poll() not in (None, 0) and key not in expected_exit:
                    raise RuntimeError(f"durable group {key} exited with {p.returncode}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"durable phase: {what}")
            time.sleep(0.02)

    def go(k: int) -> None:
        wait(lambda: all(os.path.exists(os.path.join(run_dir, f"ready_{g}_{k}"))
                         for g in (0, 1)), f"incarnation {k} never got ready")
        # Both Managers heartbeat before either asks for a quorum, so the
        # lighthouse waits for both (its split-brain guard).
        time.sleep(JOIN_GRACE_S)
        write(f"go_{k}", 1)

    def got(key, head: str) -> list:
        with lock:
            return [body for h, body in lines[key] if h == head]

    def kill(key) -> float:
        t = time.time()
        expected_exit.add(key)
        procs[key].kill()
        procs[key].wait()
        lighthouse.evict(f"durable_g{key[0]}")  # the next quorum need not wait it out
        return t

    def finish(keys) -> None:
        for key in keys:
            rc = procs[key].wait(timeout=DURABLE_TIMEOUT_S)
            if rc != 0:
                raise RuntimeError(f"durable group {key} exited with {rc}")

    def n_merged(key) -> int:
        with lock:
            return len(merged(recs, key))

    def top_step() -> int:
        with lock:
            return max((r["step"] for rs in recs.values() for r in rs), default=0)

    t_phase = time.monotonic()
    events = {}
    try:
        # (a) The reference run on a lighthouse of its own, beside (b)'s
        # first incarnation: the same schedule, held at N / 2 once that
        # step's checkpoint is durable.  Four processes share the card.
        write("stop", N)
        for g in (0, 1):
            start(g, 0, {}, sync=True, lh=lighthouse_ref)
            start(g, 1, {"ckpt_dir": ckpt_dir, "hold_at": half}, sync=True)
        go(0)
        go(1)
        finish([(0, 0), (1, 0)])
        ref = {g: got((g, 0), "FINAL")[0] for g in (0, 1)}
        os.remove(os.path.join(run_dir, "stop"))
        wait(lambda: all(got((g, 1), "DURABLE") for g in (0, 1)),
             f"the groups' step-{half} checkpoints never became durable")
        for g in (0, 1):
            kill((g, 1))
        g0_dir = os.path.join(ckpt_dir, "group_0")
        whole = os.path.join(g0_dir, f"step_{half:012d}.tpuft")
        torn = os.path.join(g0_dir, f"step_{half + 2:012d}.tpuft")
        with open(whole, "rb") as src, open(torn, "wb") as dst:
            dst.write(src.read(os.path.getsize(whole) // 2))
        with open(os.path.join(g0_dir, f"step_{half + 4:012d}.tpuft.tmp"), "wb") as f:
            f.write(b"\0" * 4096)
        print(f"  (b) planted in group 0's directory: {os.path.basename(torn)} (the first "
              f"half of step {half}'s file) and a stray .tmp; on disk "
              f"{sorted(os.listdir(g0_dir))}", flush=True)
        for g in (0, 1):
            start(g, 2, {"ckpt_dir": ckpt_dir}, sync=True)
        go(2)
        wait(lambda: all(any(r["step"] >= N and r["committed"] for r in list(recs[(g, 2)]))
                         for g in (0, 1)), f"the resumed groups never reached step {N}")
        # (c) Group 1 lost with its disk: a cold start healed over send/recv.
        write("ckpt_off", 1)
        events["kill_c"] = kill((1, 2))
        shutil.rmtree(os.path.join(ckpt_dir, "group_1"))
        start(1, 3, {"ckpt_dir": ckpt_dir}, sync=False)
        wait(lambda: n_merged((1, 3)) >= DURABLE_MERGED,
             "group 1 never ran merged after its collective heal")
        # (d) Group 1 on the baby collective; its child SIGKILLed in an
        # allreduce after DURABLE_MERGED merged commits.
        events["kill_d"] = kill((1, 3))
        expected_exit.add((1, 4))
        start(1, 4, {"baby": True, "kill_child": True}, sync=False)
        wait(lambda: procs[(1, 4)].poll() is not None, "the baby group never exited")
        events["exit_d"] = time.time()
        lighthouse.evict("durable_g1")
        start(1, 5, {"baby": True}, sync=False)
        wait(lambda: n_merged((1, 5)) >= DURABLE_MERGED,
             "group 1 never ran merged after the baby's crash and restart")
        write("stop", top_step() + 1)
        finish([(0, 2), (1, 5)])
        streams = {key: report.read_events([os.path.join(run_dir, f"metrics_{key[0]}_"
                                                                  f"{key[1]}.jsonl")])
                   for key in procs}
        ckpt_listing = {g: sorted(os.listdir(os.path.join(ckpt_dir, f"group_{g}")))
                        for g in (0, 1) if os.path.isdir(os.path.join(ckpt_dir, f"group_{g}"))}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        lighthouse.shutdown()
        lighthouse_ref.shutdown()
        shutil.rmtree(run_dir, ignore_errors=True)
    phase_s = time.monotonic() - t_phase
    with lock:
        out = {key: list(v) for key, v in lines.items()}
    return durable_checks(card, recs, out, streams, events, starts, ref, ckpt_listing,
                          http_striped, state_bytes, phase_s)


def durable_checks(card: str, recs: dict, lines: dict, streams: dict, events: dict,
                   starts: dict, ref: dict, ckpt_listing: dict, http_striped: dict,
                   state_bytes: int, phase_s: float) -> dict:
    """Phase 13's assertions and prints; returns the K1-K5 launches of all
    its processes."""
    cfg, _, _ = cut_config(DURABLE_LAYERS)
    N, half = DURABLE_STEPS, DURABLE_STEPS // 2
    per_step = {"flash_fwd": cfg.n_layers, "flash_bwd_dkdv": cfg.n_layers,
                "flash_bwd_dq": cfg.n_layers, "ce_lse": 1, "ce_dlogits": 1}

    def body(key, head):
        return [b for h, b in lines[key] if h == head]

    def sha_at(key, step):
        return next((r["sha"] for r in recs[key] if r["committed"] and r["step"] == step), None)

    launches = {name: 0 for name in per_step}
    for key, rs in sorted(recs.items()):
        if not rs:
            raise AssertionError(f"durable group {key} printed no step")
        steps = len(rs)
        for name, n in per_step.items():
            got = rs[-1]["launches"].get(name, 0)
            if got != n * steps:
                raise AssertionError(f"durable group {key}: {name} launched {got} times in "
                                     f"{steps} steps, expected {n * steps}")
            launches[name] += got

    # (a) The reference.
    if ref[0]["sha"] != ref[1]["sha"] or ref[0]["step"] != N:
        raise AssertionError(f"(a) the groups ended apart: {ref}")
    for key in ((0, 0), (1, 0)):
        if not all(r["committed"] and r["participants"] == 2 for r in recs[key]):
            raise AssertionError(f"(a) group {key} ran a step that was not a merged commit")
    print(f"  (a) {N} merged steps uninterrupted: params_sha256 {ref[0]['sha'][:16]}… on both "
          f"groups", flush=True)

    # (b) The stop at N / 2 and the resume.
    # Each save by step: its record once durable, and the loop's call that
    # made it.
    saves = {}
    for key in ((0, 1), (1, 1), (0, 2), (1, 2)):
        calls = {}
        for r in recs[key]:
            for sv in r.get("saves", []) + [d["save"] for d in body(key, "DURABLE")]:
                if sv and ("write_ms" in sv or sv["step"] not in saves.get(key, {})):
                    saves.setdefault(key, {})[sv["step"]] = sv
            if r.get("saves") and r["saves"][-1].get("step") == r["step"]:
                calls[r["step"]] = r["save_call_ms"]
        saves[key] = {step: (sv, calls.get(step, float("nan")))
                      for step, sv in saves.get(key, {}).items()}
    for g in (0, 1):
        durable, = body((g, 1), "DURABLE")
        resumed, = body((g, 2), "RESUMED")
        if durable["step"] != half or resumed["step"] != half:
            raise AssertionError(f"(b) group {g} held at {durable['step']} and resumed at "
                                 f"{resumed['step']}, expected {half}")
        if resumed["digest"] != durable["digest"]:
            raise AssertionError(f"(b) group {g}'s restored state {resumed['digest']} is not "
                                 f"the saved {durable['digest']}")
        if not all(d.startswith(resumed["device"]) for d in resumed["model_devices"]):
            raise AssertionError(f"(b) group {g}'s restored tensors are on "
                                 f"{resumed['model_devices']}")
        if resumed["loader"] != durable["loader"]:
            raise AssertionError(f"(b) group {g}'s loader resumed at {resumed['loader']}, "
                                 f"saved at {durable['loader']}")
        first = recs[(g, 2)][0]
        if first["before"] != half or first["healed"] or not first["committed"]:
            raise AssertionError(f"(b) group {g}'s first resumed step: {first}")
        if any(e["event"] == "heal_start" and float(e["ts"]) < events["kill_c"]
               for e in streams[(g, 2)]):
            raise AssertionError(f"(b) group {g} healed after its disk resume")
        end = sha_at((g, 2), N)
        if end != ref[g]["sha"]:
            raise AssertionError(f"(b) group {g} ended step {N} with {end}, run (a) with "
                                 f"{ref[g]['sha']}")
        print(f"  (b) group {g}: held at step {half} ({durable['wait_s']:.3f} s waiting for the "
              f"write), restarted -> 'resumed from disk checkpoint step={half}' in "
              f"{resumed['t'] - starts[(g, 2)]:.3f} s (restore {resumed['restore_s']:.3f} s), "
              f"state sha256 {resumed['digest'][:16]}… = saved, loader {resumed['loader']}, "
              f"tensors on {resumed['model_devices']}; step {N} params_sha256 = run (a)'s "
              f"({card})", flush=True)
        for key in ((g, 1), (g, 2)):
            for step, (s, call_ms) in sorted(saves.get(key, {}).items()):
                print(f"      save step {step}: {s['bytes'] / 1e9:.3f} GB, flatten (enqueue) "
                      f"{s['flatten_ms']:.1f} ms, backpressure stall {s['stall_ms']:.1f} ms, "
                      f"durable write {s.get('write_ms', float('nan')):.1f} ms, the loop's "
                      f"save call {call_ms:.1f} ms ({card})", flush=True)
    for key in saves:
        for step, (s, _) in saves[key].items():
            if abs(s["bytes"] - state_bytes) > 1e6:
                raise AssertionError(f"(b) group {key}'s step-{step} checkpoint is {s['bytes']} "
                                     f"bytes, expected about {state_bytes}")
    print(f"  (b) on disk after the run: {ckpt_listing}", flush=True)

    # (c) The cold start healed over the collective transport.
    heal_recs = [r for r in recs[(1, 3)] if "fetch" in r]
    if len(heal_recs) != 1 or heal_recs[0]["fetch"]["mode"] != "collective":
        raise AssertionError(f"(c) group 1 did not heal once over the collective: {heal_recs}")
    heal = heal_recs[0]
    fetch = heal["fetch"]
    spans = [e for e in streams[(1, 3)] if e["event"] == "span" and e.get("phase") == "heal"]
    if not spans or abs(spans[0].get("bytes", 0) - state_bytes) > 1e6:
        raise AssertionError(f"(c) the heal span does not carry the state: {spans[:1]}")
    if sha_at((0, 2), heal["step"]) != heal["sha"]:
        raise AssertionError(f"(c) group 1's healed state at step {heal['step']} is not group "
                             f"0's")
    check_merged_tail(recs, (0, 2), (1, 3), "(c)")
    resumed_c = body((1, 3), "RESUMED")
    if resumed_c:
        raise AssertionError(f"(c) group 1 resumed from a deleted directory: {resumed_c}")
    print(f"  (c) group 1 cold-started and healed over CollectiveTransport: "
          f"{fetch['bytes'] / 1e9:.3f} GB in {fetch['fetch_s']:.3f} s "
          f"({fetch['gb_per_s']:.3f} GB/s) against phase 11's HTTP striped transfer "
          f"{http_striped['fetch_s']:.3f} s ({http_striped['gb_per_s']:.3f} GB/s, taken beside "
          f"{http_striped['beside']}); the heal "
          f"span {spans[0]['duration_ms']:.1f} ms; SIGKILL -> first merged commit "
          f"{merged_first(recs, (1, 3)) - events['kill_c']:.3f} s ({card})", flush=True)

    # Membership callbacks against the streams' events.
    keys = ("quorum_id", "old_participants", "new_participants", "joined", "left",
            "transition_s", "mode", "elastic_plan")
    for key in sorted(lines):
        seen = body(key, "MEMBERSHIP")
        evs = [{k: e.get(k) for k in keys} for e in streams[key]
               if e["event"] == "membership_change"]
        if seen != evs or not evs:
            raise AssertionError(f"group {key}'s membership callbacks {seen} are not its "
                                 f"events {evs}")
    g0 = [(m["joined"], m["left"]) for m in body((0, 2), "MEMBERSHIP")]
    if g0[:3] != [([0, 1], []), ([], [1]), ([1], [])]:
        raise AssertionError(f"(c) group 0's membership changes {g0}")
    print(f"  membership callbacks = membership_change events in every process; group 0's "
          f"resumed incarnation saw (joined, left) {g0}", flush=True)

    # (d) The baby collective and its child's crash.
    killed, = body((1, 4), "CHILD_KILLED")
    opfail, = body((1, 4), "OPFAIL")
    exceeded, = body((1, 4), "EXCEEDED")
    before = [r for r in recs[(1, 4)] if r["t"] < killed["t"]]
    after = [r for r in recs[(1, 4)] if r["t"] > killed["t"]]
    if sum(r["committed"] and r["participants"] == 2 for r in before) < DURABLE_MERGED:
        raise AssertionError("(d) the baby group ran under DURABLE_MERGED merged commits")
    if not ("collective subprocess died (exit code -9)" in opfail["exc"]
            and opfail["dt"] < DURABLE_BABY_TIMEOUT_S):
        raise AssertionError(f"(d) the op in flight failed with {opfail}")
    if {r["pid"] for r in recs[(1, 4)]} != {killed["pid"]} or exceeded["pid"] != killed["pid"]:
        raise AssertionError("(d) the baby group's process did not survive its child")
    if not after or any(r["committed"] for r in after) or not all(
            r["errored"] and "exit code -9" in r["errored"] for r in after):
        raise AssertionError(f"(d) after the child's death: {after}")
    if "max_retries=2" not in exceeded["error"] or "exit code -9" not in exceeded["errored"]:
        raise AssertionError(f"(d) the baby group exited with {exceeded}")
    if len({r["configure"].get("pid") for r in recs[(1, 4)]}) != 1:
        raise AssertionError("(d) the baby respawned its child without a new quorum")
    g0_fail = [r for r in recs[(0, 2)] if not r["committed"] and r["t"] > killed["t"]]
    if not g0_fail or g0_fail[0]["before"] != killed["step"]:
        raise AssertionError(f"(d) group 0's vote at the baby's step {killed['step']} did not "
                             f"fail: {g0_fail[:1]}")
    check_merged_tail(recs, (0, 2), (1, 5), "(d)")
    plain = [r["step_s"] for key in ((0, 2), (1, 3)) for r in merged(recs, key, events["kill_c"])
             if r["t"] < events["kill_d"]]
    with_baby = [r["step_s"] for key in ((0, 2), (1, 4)) for r in merged(recs, key,
                                                                         events["kill_d"])
                 if r["t"] < killed["t"]]
    cfg_ms = sorted({round(r["configure"]["configure_ms"], 1) for key in ((1, 4), (1, 5))
                     for r in recs[key]})
    baby_fetch = [r["fetch"] for key in ((1, 4), (1, 5)) for r in recs[key] if "fetch" in r]
    print(f"  (d) merged step, median over both groups: {1e3 * statistics.median(plain):.1f} "
          f"ms on the plain ring ((c), {len(plain)} group-steps), "
          f"{1e3 * statistics.median(with_baby):.1f} ms with "
          f"group 1 on the baby collective ({len(with_baby)} group-steps); the baby's "
          f"configure {cfg_ms} ms; its heals {[round(f['fetch_s'], 3) for f in baby_fetch]} s "
          f"for {baby_fetch[0]['bytes'] / 1e9:.3f} GB ({card})", flush=True)
    print(f"  (d) child SIGKILL (pid {killed['child']}, step {killed['step']}) -> the op in "
          f"flight failed {opfail['dt']:.3f} s ({opfail['exc']}); {len(after)} failed votes on "
          f"the same process (pid {killed['pid']}) -> ExceededMaxRetriesError "
          f"{exceeded['t'] - killed['t']:.3f} s, process exit "
          f"{events['exit_d'] - killed['t']:.3f} s, the restart's first merged commit "
          f"{merged_first(recs, (1, 5)) - killed['t']:.3f} s; group 0's failed votes "
          f"{len([r for r in g0_fail if r['t'] < events['exit_d']])} ({card})", flush=True)
    peak = max(r["peak_mem"] for rs in recs.values() for r in rs)
    print(f"  durable phase: {phase_s:.1f} s; peak device memory of a process "
          f"{peak / 2**30:.2f} GiB ({card})", flush=True)
    print("DURABLE_PHASE " + json.dumps({
        "phase_s": phase_s, "ref_sha": ref[0]["sha"], "collective_heal": fetch,
        "http_striped": http_striped, "baby_opfail": opfail, "merged_plain_s": plain,
        "merged_baby_s": with_baby, "baby_configure_ms": cfg_ms,
        "kill_child_to_exit_s": events["exit_d"] - killed["t"]}), flush=True)
    return launches


# -- phase 14: the highly-available and federated control plane --------------------

# The control plane's depth: the flagship's width at half its 12 layers,
# cut so that phase 16 fits the run's time.
CONTROL_LAYERS = 6
CONTROL_STEPS = 14          # each run's steps, both groups merged from step 0
CONTROL_KILL_AT = 4         # merged commits of each group before the leader's SIGKILL
CONTROL_AFTER = 6           # merged commits of each group at least after it
CONTROL_LEASE_MS = 1500     # the HA pair's --lease-ms
CONTROL_TIMEOUT_S = 300.0


def run_control_group(args: argparse.Namespace) -> None:
    """One replica group of phase 14: the flagship (one seed for both
    groups, so no step-0 sync; each step's batch seeded by group and step)
    on the native 2-lane TCP f32 ring, two runs in one process: (a) through
    the HA pair's address list, (b) through its region's lighthouse.  Each
    run waits for ``go_<run>_<g>`` (the lighthouse addresses), rebuilds the
    model, AdamW, the collective and the Manager, and runs CONTROL_STEPS
    steps; every step prints its commit, quorum id and the ring's configure
    count."""
    import logging
    from datetime import timedelta

    import torch

    from torchft_tpu_torch.collectives import TCPCollective
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.models import Transformer, loss_fn, resolve_device
    from torchft_tpu_torch.ops import launch_counts, reset_launch_counts
    from torchft_tpu_torch.parallel import TrainStep

    group, run_dir = args.control_group, args.run_dir
    path = lambda name: os.path.join(run_dir, name)  # noqa: E731
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format=f"[c{group}] %(message)s")
    cfg, batch, seq = cut_config(CONTROL_LAYERS)
    dev = resolve_device(args.device)
    reset_launch_counts()
    steps_run = 0
    for run in ("a", "b"):
        go = path(f"go_{run}_{group}")
        deadline = time.monotonic() + CONTROL_TIMEOUT_S
        while not os.path.exists(go):
            if time.monotonic() > deadline:
                raise TimeoutError(f"control group {group}: {go} never appeared")
            time.sleep(0.02)
        with open(go) as f:
            lighthouse = f.read().strip()
        model = Transformer(cfg, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(4400))
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)

        def save():
            return {"model": model.state_dict(), "optim": opt.state_dict()}

        def load(sd) -> None:
            model.load_state_dict(sd["model"])
            opt.load_state_dict(sd["optim"])

        collective = TCPCollective(timeout=180.0, host="127.0.0.1")
        configures = [0]
        configure = collective.configure

        def counted(*a, **kw):
            configures[0] += 1
            return configure(*a, **kw)

        collective.configure = counted
        os.environ["TPUFT_METRICS_PATH"] = path(f"metrics_{run}_{group}.jsonl")
        timeout = timedelta(seconds=180)
        manager = Manager(
            collective=collective, load_state_dict=load, state_dict=save, min_replica_size=2,
            rank=0, world_size=1, replica_id=str(group), lighthouse_addr=lighthouse,
            store_addr="127.0.0.1", manager_bind="127.0.0.1:0", timeout=timeout,
            quorum_timeout=timeout, init_sync=False,
        )
        trainer = TrainStep(model, opt, loss_fn, manager)
        try:
            while manager.current_step() < CONTROL_STEPS:
                if steps_run > 4 * CONTROL_STEPS:
                    raise RuntimeError(f"control group {group}: run {run} never reached step "
                                       f"{CONTROL_STEPS}")
                before = manager.current_step()
                manager.start_quorum()
                gen = torch.Generator(device=dev).manual_seed(4500 + 1000 * group + before)
                tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=dev)
                t0 = time.perf_counter()
                loss, committed = trainer.ft_step({"tokens": tokens,
                                                   "targets": torch.roll(tokens, -1, dims=1)})
                loss_v = float(loss)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                steps_run += 1
                rec = {"run": run, "group": group, "before": before,
                       "step": manager.current_step(), "committed": committed,
                       "participants": manager.num_participants(), "loss": loss_v,
                       "step_s": time.perf_counter() - t0, "t": time.time(),
                       "quorum_id": manager._quorum_id, "configures": configures[0],
                       "ring": (collective.ring_engine, collective.lanes, collective.wire_dtype,
                                collective.ring_transport)}
                print("STEP " + json.dumps(rec), flush=True)
                if committed and not math.isfinite(loss_v):
                    raise RuntimeError(f"control group {group}: loss {loss_v} is not finite")
            h = hashlib.sha256()
            for name, p in model.state_dict().items():
                h.update(name.encode())
                h.update(p.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()
                         .tobytes())
            print("FINAL " + json.dumps({"run": run, "group": group, "step":
                                         manager.current_step(), "sha": h.hexdigest(),
                                         "steps_run": steps_run, "launches": launch_counts(),
                                         "replica_id": manager.replica_id()}), flush=True)
        finally:
            manager.shutdown()
        del trainer, manager, model, opt
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def device_fds(pid: int) -> list:
    """The /dev/nvidia* files a process holds open: none for a process that
    never initialized CUDA."""
    out = []
    fd_dir = f"/proc/{pid}/fd"
    for fd in os.listdir(fd_dir):
        try:
            target = os.readlink(os.path.join(fd_dir, fd))
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            out.append(target)
    return sorted(set(out))


def metric_lines(http: str, prefix: str) -> list:
    import urllib.request

    text = urllib.request.urlopen(f"{http}/metrics", timeout=10).read().decode()
    return [line for line in text.splitlines() if line.startswith(prefix)]


def rpc_count(http: str, method: str) -> int:
    """The count of ``tpuft_rpc_latency_seconds{method=...}`` on a
    lighthouse's /metrics (0 when the series is absent), as
    ``bench_scale.py`` reads the root's heartbeat fan-in."""
    for line in metric_lines(http, "tpuft_rpc_latency_seconds_count"):
        if f'method="{method}"' in line:
            return int(float(line.rsplit(" ", 1)[1]))
    return 0


def control_phase(card: str, device: str = "cuda") -> dict:
    """(a) Two HA lighthouse replicas (``python -m
    torchft_tpu_torch.lighthouse_cli --lease-file ... --lease-ms
    CONTROL_LEASE_MS``, one lease file) and two flagship groups through
    ``TPUFT_LIGHTHOUSE``-style ``A,B``; after CONTROL_KILL_AT merged commits
    of each group the leader's process is SIGKILLed; the groups run on to
    CONTROL_STEPS; then the port Launcher's client evicts group 1 through
    ``A,B``.  (b) A root (``--min_replicas 2``) and two region lighthouses
    (``--region r0|r1 --root-addrs <root>``), one group in each region, the
    same schedule uninterrupted: it is (a)'s reference.  Returns the K1-K5
    launches of both groups."""
    import urllib.request

    from torchft_tpu_torch._native import LighthouseClient
    from torchft_tpu_torch.launch import Launcher
    from torchft_tpu_torch.models import flagship_config
    from torchft_tpu_torch.obs import report

    run_dir = tempfile.mkdtemp(prefix="tpuft_control_")
    path = lambda name: os.path.join(run_dir, name)  # noqa: E731
    lh_procs, lh_logs, groups, recs, finals = {}, {}, {}, [], {}
    lock = threading.Lock()
    expected_dead = set()

    def lighthouse(name: str, *argv: str) -> None:
        lh_logs[name] = open(path(f"lh_{name}.log"), "w")
        env = {**os.environ, "TPUFT_METRICS_PATH": path("lighthouses.jsonl")}
        lh_procs[name] = subprocess.Popen(
            [sys.executable, "-m", "torchft_tpu_torch.lighthouse_cli", *argv], cwd=HERE,
            env=env, stdout=lh_logs[name], stderr=subprocess.STDOUT)

    def start_group(g: int) -> None:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--control-group", str(g), "--run-dir",
             run_dir, "--device", device], stdout=subprocess.PIPE, text=True, cwd=HERE)
        groups[g] = proc

        def read() -> None:
            for line in proc.stdout:
                line = line.rstrip("\n")
                head, _, body = line.partition(" ")
                if head in ("STEP", "FINAL"):
                    rec = json.loads(body)
                    with lock:
                        (recs.append(rec) if head == "STEP"
                         else finals.__setitem__((rec["run"], g), rec))
                    if head == "STEP":
                        short = {k: rec[k] for k in ("step", "committed", "participants",
                                                     "quorum_id", "configures")}
                        print(f"  [c{g}.{rec['run']}] STEP {json.dumps(short)} "
                              f"{rec['step_s'] * 1e3:.1f} ms", flush=True)
                        continue
                print(f"  [c{g}] {line}", flush=True)

        threading.Thread(target=read, daemon=True).start()

    def check_alive() -> None:
        for name, p in lh_procs.items():
            if p.poll() is not None and name not in expected_dead:
                lh_logs[name].flush()
                with open(path(f"lh_{name}.log")) as f:
                    tail = f.read()[-3000:]
                raise RuntimeError(f"lighthouse {name} exited with {p.returncode}:\n{tail}")
        for g, p in groups.items():
            if p.poll() not in (None, 0):
                raise RuntimeError(f"control group {g} exited with {p.returncode}")

    def wait(cond, what: str, timeout: float = CONTROL_TIMEOUT_S) -> None:
        deadline = time.monotonic() + timeout
        while not cond():
            check_alive()
            if time.monotonic() > deadline:
                raise TimeoutError(f"control phase: {what}")
            time.sleep(0.02)

    def leader_info(addr: str):
        client = LighthouseClient(addr, connect_timeout_ms=500)
        try:
            return client.leader(timeout_ms=1000)
        except Exception:  # noqa: BLE001 - not up yet, or dead
            return None
        finally:
            client.close()

    def go(run: str, g: int, addrs: str) -> None:
        tmp = path(f"go_{run}_{g}.tmp")
        with open(tmp, "w") as f:
            f.write(addrs)
        os.replace(tmp, path(f"go_{run}_{g}"))

    def run_recs(run: str, g: int) -> list:
        with lock:
            return [r for r in recs if r["run"] == run and r["group"] == g]

    def merged_n(run: str, g: int, after: float = 0.0) -> int:
        return sum(1 for r in run_recs(run, g) if r["committed"] and r["participants"] == 2
                   and r["t"] > after)

    def no_device(names) -> dict:
        fds = {name: device_fds(lh_procs[name].pid) for name in names}
        bad = {k: v for k, v in fds.items() if v}
        if bad:
            raise AssertionError(f"lighthouse processes hold the card open: {bad}")
        return fds

    def stop(names) -> dict:
        for name in names:
            expected_dead.add(name)
            lh_procs[name].send_signal(signal.SIGTERM)
        rcs = {name: lh_procs[name].wait(timeout=30) for name in names}
        if any(rcs.values()):
            raise AssertionError(f"lighthouses exited with {rcs} on SIGTERM")
        return rcs

    t_phase = time.monotonic()
    out: dict = {"card": card}
    try:
        # (a) The HA pair: both started before the groups; the groups list
        # both addresses.
        rpc = {n: f"127.0.0.1:{free_port()}" for n in ("A", "B")}
        for n, peer in (("A", "B"), ("B", "A")):
            lighthouse(n, "--bind", rpc[n], "--http_bind", f"127.0.0.1:{free_port()}",
                       "--min_replicas", "2", "--lease-file", path("lease"), "--lease-ms",
                       str(CONTROL_LEASE_MS), "--peers", rpc[peer])
        for g in (0, 1):
            start_group(g)
        # (b)'s root and regions start now, so their start-up hides behind (a).
        rpc.update({n: f"127.0.0.1:{free_port()}" for n in ("root", "r0", "r1")})
        root_http = f"127.0.0.1:{free_port()}"
        lighthouse("root", "--bind", rpc["root"], "--http_bind", root_http, "--min_replicas",
                   "2")
        for n in ("r0", "r1"):
            lighthouse(n, "--bind", rpc[n], "--http_bind", f"127.0.0.1:{free_port()}",
                       "--region", n, "--root-addrs", rpc["root"])
        addrs = f"{rpc['A']},{rpc['B']}"
        wait(lambda: any((leader_info(rpc[n]) or {}).get("role") == 1 for n in "AB"),
             "no HA lighthouse was elected", timeout=120.0)
        leader = next(n for n in "AB" if (leader_info(rpc[n]) or {}).get("role") == 1)
        standby = "B" if leader == "A" else "A"
        epoch0 = leader_info(rpc[leader]).leader.leader_epoch
        t0 = time.monotonic()
        for g in (0, 1):
            go("a", g, addrs)
        wait(lambda: all(merged_n("a", g) >= CONTROL_KILL_AT for g in (0, 1)),
             f"the groups never ran {CONTROL_KILL_AT} merged steps on the HA pair")
        out["lighthouse_fds"] = no_device(["A", "B"])
        group_fds = {g: device_fds(p.pid) for g, p in groups.items()}
        if device == "cuda" and not all(group_fds.values()):
            raise AssertionError(f"the device-file probe sees no card in the groups: {group_fds}")
        expected_dead.add(leader)
        t_kill_wall, t_kill = time.time(), time.monotonic()
        lh_procs[leader].send_signal(signal.SIGKILL)
        lh_procs[leader].wait()
        takeover = {}

        def took_over() -> bool:
            info = leader_info(rpc[standby])
            if info is not None and info.role == 1 and info.leader.leader_epoch == epoch0 + 1:
                takeover["s"] = time.monotonic() - t_kill
                return True
            return False

        wait(took_over, f"no takeover within {3 * CONTROL_LEASE_MS} ms",
             timeout=3 * CONTROL_LEASE_MS / 1e3)
        wait(lambda: all(any(r["committed"] and r["step"] >= CONTROL_STEPS
                             for r in run_recs("a", g)) for g in (0, 1)),
             "the groups never finished run (a) after the takeover")
        http_b = leader_info(rpc[standby]).leader.leader_http_address
        out["replica_step"] = metric_lines(http_b, "tpuft_replica_step{")
        wait(lambda: all(("a", g) in finals for g in (0, 1)), "run (a) printed no FINAL")
        out["a_s"] = time.monotonic() - t0
        # The port Launcher's evict of group 1 through "A,B": its client
        # fails over past the dead A (or follows B) to the new leader.
        status = LighthouseClient(rpc[standby])
        ids = lambda: sorted(status.status().heartbeat_age_ms)  # noqa: E731
        before = ids()
        launcher = Launcher([sys.executable, "-c", "pass"], num_groups=2, lighthouse=addrs)
        launcher._evict_from_lighthouse(1)
        launcher._evict_client.close()
        after = ids()
        status.close()
        out["evict"] = {"before": before, "after": after,
                        "evicted": len(before) - len(after)}
        out["fds_a"] = no_device([standby])
        stop([standby])

        # (b) Two regions and a root; one group in each region.
        def regions() -> dict:
            try:
                return json.loads(urllib.request.urlopen(f"http://{root_http}/regions.json",
                                                         timeout=5).read())
            except OSError:
                return {}

        wait(lambda: sum(not r.get("stale") for r in regions().get("regions", [])) == 2,
             "the root never saw two fresh regions", timeout=120.0)
        t0 = time.monotonic()
        for g in (0, 1):
            go("b", g, rpc[f"r{g}"])
        wait(lambda: all(("b", g) in finals for g in (0, 1)), "run (b) printed no FINAL")
        out["b_s"] = time.monotonic() - t0
        out["regions"] = regions()
        out["root_heartbeat_rpcs"] = rpc_count(f"http://{root_http}", "Heartbeat")
        out["root_digest_rpcs"] = rpc_count(f"http://{root_http}", "RegionDigest")
        out["fds_b"] = no_device(["root", "r0", "r1"])
        stop(["root", "r0", "r1"])
        for g, p in groups.items():
            if p.wait(timeout=CONTROL_TIMEOUT_S) != 0:
                raise RuntimeError(f"control group {g} exited with {p.returncode}")
        streams = {(run, g): report.read_events([path(f"metrics_{run}_{g}.jsonl")])
                   for run in ("a", "b") for g in (0, 1)}
        lh_events = report.read_events([path("lighthouses.jsonl")])
    finally:
        for p in list(groups.values()) + list(lh_procs.values()):
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in lh_logs.values():
            f.close()
        shutil.rmtree(run_dir, ignore_errors=True)
    out["phase_s"] = time.monotonic() - t_phase
    with lock:
        out.update(recs=list(recs), finals=dict(finals))
    return control_checks(out, streams, lh_events, rpc, leader, standby, epoch0, takeover["s"],
                          t_kill_wall)


def control_checks(out: dict, streams: dict, lh_events: list, rpc: dict, leader: str,
                   standby: str, epoch0: int, takeover_s: float, t_kill: float) -> dict:
    """Phase 14's assertions and prints; returns the K1-K5 launches of both
    groups."""

    card, recs, finals = out["card"], out["recs"], out["finals"]
    cfg, _, _ = cut_config(CONTROL_LAYERS)
    print(f"  (a) HA pair {rpc['A']}, {rpc['B']} (lease {CONTROL_LEASE_MS} ms): leader {leader} "
          f"at epoch {epoch0} SIGKILLed; {standby} led at epoch {epoch0 + 1} after "
          f"takeover_s {takeover_s:.3f} s ({card})", flush=True)
    failed = [(r["run"], r["group"], r["before"]) for r in recs if not r["committed"]]
    for run, g, step in failed:
        print(f"  FAILED COMMIT: run ({run}) group {g} at step {step}", flush=True)
    if failed:
        raise AssertionError(f"failed commits {failed}")
    for r in recs:
        if r["ring"] != ["native", 2, "f32", "tcp"]:
            raise AssertionError(f"run ({r['run']}) group {r['group']} ran the ring {r['ring']}")
    failovers = [e for e in lh_events if e.get("event") == "lighthouse_failover"]
    print(f"  lighthouse_failover events: "
          f"{[(e.get('replica_id'), e.get('leader_epoch')) for e in failovers]}", flush=True)
    if [(e.get("replica_id"), e.get("leader_epoch")) for e in failovers] != [
            (f"lighthouse:{rpc[standby]}", epoch0 + 1)]:
        raise AssertionError(f"expected one lighthouse_failover, {standby}'s at epoch "
                             f"{epoch0 + 1}: {failovers}")
    for g in (0, 1):
        rs = [r for r in recs if r["run"] == "a" and r["group"] == g]
        pre = [r for r in rs if r["t"] <= t_kill]
        post = [r for r in rs if r["t"] > t_kill]
        times = [r["t"] for r in rs if r["committed"]]
        gaps = [b - a for a, b in zip(times, times[1:])]
        # The step in flight at the kill had its quorum already; the next
        # step's quorum waits for the takeover.
        across = min((b - a for a, b in zip(times, times[1:]) if a <= t_kill < b), default=0.0)
        resume = max(b - a for a, b in zip(times, times[1:]) if b > t_kill)
        out.setdefault("resume_gap_s", {})[g] = resume
        print(f"  (a) group {g}: quorum id / ring configures at the last step before the kill "
              f"{pre[-1]['quorum_id']} / {pre[-1]['configures']}, at the first after "
              f"{post[0]['quorum_id']} / {post[0]['configures']}, at the end "
              f"{rs[-1]['quorum_id']} / {rs[-1]['configures']}; gap between commits: the one "
              f"holding the kill {across:.3f} s, the longest after it {resume:.3f} s, the "
              f"longest {max(gaps):.3f} s, median {statistics.median(gaps):.3f} s; "
              f"{len(post)} merged steps after the kill ({card})", flush=True)
        if rs[-1]["configures"] != pre[-1]["configures"] or (
                rs[-1]["quorum_id"] != pre[-1]["quorum_id"]):
            raise AssertionError(f"group {g} reconfigured its ring across the takeover: quorum "
                                 f"ids {[r['quorum_id'] for r in rs]}")
        if len(post) < CONTROL_AFTER:
            raise AssertionError(f"group {g} ran {len(post)} merged steps after the kill")
    print(f"  (a) the new leader's tpuft_replica_step: {out['replica_step']}", flush=True)
    if len([x for x in out["replica_step"] if 'replica="0:' in x or 'replica="1:' in x]) != 2:
        raise AssertionError(f"the new leader does not track both groups: {out['replica_step']}")
    ev = out["evict"]
    print(f"  (a) the port Launcher's evict of group 1 through {rpc['A']},{rpc['B']}: evicted "
          f"{ev['evicted']} ({ev['before']} -> {ev['after']})", flush=True)
    if ev["evicted"] != 1 or any(x.startswith("1:") for x in ev["after"]):
        raise AssertionError(f"the evict of group 1 did not reach the new leader: {ev}")
    shas = {key: f["sha"] for key, f in finals.items()}
    print(f"  params_sha256: (a) {shas[('a', 0)]} / {shas[('a', 1)]}, (b) uninterrupted "
          f"{shas[('b', 0)]} / {shas[('b', 1)]}", flush=True)
    if len(set(shas.values())) != 1:
        raise AssertionError(f"the runs ended with different parameters: {shas}")
    # (b): each step's quorum span, from the Managers' streams.
    for g in (0, 1):
        spans = [(e["step"], e["quorum_ms"]) for e in streams[("b", g)]
                 if e.get("event") == "quorum"]
        ms = [s for _, s in spans]
        print(f"  (b) group {g} (region r{g}) quorum span a step, ms: "
              + ", ".join(f"{s}:{m:.1f}" for s, m in spans)
              + f"; first {ms[0]:.1f}, median of the rest {statistics.median(ms[1:]):.1f} "
              f"({card})", flush=True)
        spans_a = [e["quorum_ms"] for e in streams[("a", g)] if e.get("event") == "quorum"]
        print(f"  (a) group {g} quorum span median {statistics.median(spans_a):.1f} ms, longest "
              f"{max(spans_a):.1f} ms ({card})", flush=True)
    rows = out["regions"].get("regions", [])
    print(f"  (b) root regions(): {json.dumps(out['regions'])}; root RPCs: Heartbeat "
          f"{out['root_heartbeat_rpcs']}, RegionDigest {out['root_digest_rpcs']}", flush=True)
    if sorted(r["region"] for r in rows) != ["r0", "r1"] or any(r.get("stale") for r in rows):
        raise AssertionError(f"the root's regions are not both fresh: {rows}")
    if out["root_heartbeat_rpcs"] != 0 or out["root_digest_rpcs"] <= 0:
        raise AssertionError("the root fielded heartbeats, or no digests")
    print(f"  lighthouse processes' /dev/nvidia* files: {out['lighthouse_fds']}, "
          f"{out['fds_a']}, {out['fds_b']} (none: no CUDA)", flush=True)
    per_step = {"flash_fwd": cfg.n_layers, "flash_bwd_dkdv": cfg.n_layers,
                "flash_bwd_dq": cfg.n_layers, "ce_lse": 1, "ce_dlogits": 1}
    launches = {name: 0 for name in per_step}
    for g in (0, 1):
        f = finals[("b", g)]
        for name, k in per_step.items():
            if f["launches"].get(name) != k * f["steps_run"]:
                raise AssertionError(f"control group {g}: {name} launched "
                                     f"{f['launches'].get(name)} times in {f['steps_run']} steps")
            launches[name] += f["launches"][name]
    print("CONTROL " + json.dumps({
        "card": card, "takeover_s": takeover_s, "lease_ms": CONTROL_LEASE_MS,
        "resume_gap_s": out["resume_gap_s"], "failed_commits": 0, "evicted": ev["evicted"], "a_s": out["a_s"], "b_s": out["b_s"],
        "phase_s": out["phase_s"], "launches": launches}), flush=True)
    print(f"  control phase: {out['phase_s']:.1f} s (run (a) {out['a_s']:.1f} s, run (b) "
          f"{out['b_s']:.1f} s; {card})", flush=True)
    return launches


def merged(recs: dict, key, after: float = 0.0) -> list:
    return [r for r in recs[key] if r["committed"] and r["participants"] == 2 and r["t"] > after]


def merged_first(recs: dict, key) -> float:
    return merged(recs, key)[0]["t"]


def check_merged_tail(recs: dict, a, b, case: str) -> None:
    """At least DURABLE_MERGED merged commits of ``b``, each with ``a``'s
    params_sha256 at that step."""
    shas = {r["step"]: r["sha"] for r in recs[a] if r["committed"]}
    tail = merged(recs, b)
    if len(tail) < DURABLE_MERGED:
        raise AssertionError(f"{case} group {b} ran {len(tail)} merged commits")
    for r in tail:
        if shas.get(r["step"]) != r["sha"]:
            raise AssertionError(f"{case} the groups parted at step {r['step']}")


# -- phase 15: the step options on the flagship ---------------------------------------

OPTION_STEPS = 3          # full_steps of each model in (a), the first a warm-up
OVERLAP_STEPS = 4         # ft_steps of each run in (b)
OVERLAP_FAIL_AT = 2       # the ft_step of (b) whose vote fails (report_error in its loss)
# (a)'s gradients, where not bitwise: |g_remat - g| <= TOL_REMAT_GRAD * max|g|
# per tensor (the recomputed forward runs the same kernels on the same
# inputs, so any difference is the order of accumulation).
TOL_REMAT_GRAD = 1e-3


def remat_case(card: str, device: str = "cuda") -> dict:
    """Phase 15 (a): two flagship models from one seed, with and without
    remat, take the same full_steps; asserted the bitwise losses, the
    gradients within TOL_REMAT_GRAD, the launches a step and the lower peak
    with remat; printed both peaks and step times."""
    import dataclasses

    import torch

    from torchft_tpu_torch.models import Transformer, flagship_config, loss_fn
    from torchft_tpu_torch.ops import launch_counts, reset_launch_counts
    from torchft_tpu_torch.parallel import TrainStep

    cfg, batch, seq = flagship_config()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    trainers = {}
    for remat in (True, False):
        model = Transformer(dataclasses.replace(cfg, remat=remat), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(15))
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
        trainers[remat] = TrainStep(model, opt, loss_fn)
    L = cfg.n_layers
    want = {remat: {"flash_fwd": (2 if remat else 1) * L, "flash_bwd_dkdv": L,
                    "flash_bwd_dq": L, "ce_lse": 1, "ce_dlogits": 1} for remat in (True, False)}
    data = torch.Generator(device=dev).manual_seed(1515)
    out = {r: {"losses": [], "step_ms": [], "peak_bytes": [], "resident_bytes": [],
               "launches": collections.Counter()} for r in (True, False)}
    bitwise, worst = True, 0.0
    for s in range(OPTION_STEPS):
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=data, device=dev)
        b = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}
        for remat, trainer in trainers.items():
            rec = out[remat]
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                rec["resident_bytes"].append(torch.cuda.memory_allocated())
                events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                reset_launch_counts()
                events[0].record()
            t0 = time.perf_counter()
            loss = trainer.full_step(b)
            if on_card:
                events[1].record()
                events[1].synchronize()
                counts = launch_counts()
                rec["launches"].update(counts)
                rec["step_ms"].append(events[0].elapsed_time(events[1]))
                rec["peak_bytes"].append(torch.cuda.max_memory_allocated())
                got = {k: counts.get(k, 0) for k in want[remat]}
                if got != want[remat]:
                    raise AssertionError(f"remat={remat}: step {s} launched {got}, expected "
                                         f"{want[remat]}")
            else:
                rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["losses"].append(loss.float().item())
        if out[True]["losses"][-1] != out[False]["losses"][-1]:
            raise AssertionError(f"step {s}: loss {out[True]['losses'][-1]!r} with remat, "
                                 f"{out[False]['losses'][-1]!r} without")
        if not math.isfinite(out[True]["losses"][-1]):
            raise AssertionError(f"step {s}: loss {out[True]['losses'][-1]} is not finite")
        for (name, p), q in zip(trainers[True].model.named_parameters(),
                                trainers[False].model.parameters()):
            if torch.equal(p.grad, q.grad):
                continue
            bitwise = False
            err = float((p.grad - q.grad).abs().max() / q.grad.abs().max().clamp_min(1e-30))
            worst = max(worst, err)
            if err > TOL_REMAT_GRAD:
                raise AssertionError(f"step {s}: {name}'s gradient differs with remat by "
                                     f"{err:.3e} of its max, above {TOL_REMAT_GRAD}")
    result = {"bitwise_grads": bitwise, "worst_grad_err": worst,
              "losses": out[True]["losses"]}
    for remat in (True, False):
        rec = out[remat]
        steady = rec["step_ms"][1:]
        result[f"remat_{remat}"] = {
            "step_ms": rec["step_ms"], "median_step_ms": statistics.median(steady),
            "launches": dict(rec["launches"]),
            "peak_bytes": max(rec["peak_bytes"]) if rec["peak_bytes"] else None,
            "peak_above_resident_bytes": (max(p - r for p, r in zip(rec["peak_bytes"],
                                                                   rec["resident_bytes"]))
                                          if rec["peak_bytes"] else None)}
        print(f"  remat={remat}: step ms {', '.join(f'{t:.2f}' for t in rec['step_ms'])} "
              f"(CUDA events; the first a warm-up), peak device memory "
              f"{(result[f'remat_{remat}']['peak_bytes'] or 0) / 2**30:.3f} GiB, of which "
              f"{(result[f'remat_{remat}']['peak_above_resident_bytes'] or 0) / 2**30:.3f} GiB "
              f"above the resident state of both models ({card})", flush=True)
    print(f"  losses bitwise equal with and without remat: {result['losses']}; gradients "
          f"{'bitwise equal' if bitwise else f'within {worst:.3e} of each max (not bitwise)'}",
          flush=True)
    if on_card and not (result["remat_True"]["peak_bytes"] < result["remat_False"]["peak_bytes"]):
        raise AssertionError(f"remat's peak {result['remat_True']['peak_bytes']} is not below "
                             f"{result['remat_False']['peak_bytes']}")
    return result


def overlap_case(card: str, device: str = "cuda") -> dict:
    """Phase 15 (b): two flagship groups from one seed, each alone (its own
    lighthouse, min_replica_size 1), one with overlap_commit True and one
    with False, take OVERLAP_STEPS ft_steps in turns on the same batches;
    the vote of step OVERLAP_FAIL_AT fails (its loss_fn reports an error).
    Asserted: after every step both hold bitwise the same parameters and
    optimizer state; the overlapped one speculated at every step and
    restored at the failed one, the serial one never speculated.  Printed:
    each step's wall, its commit_vote span and the snapshot copy's ms."""
    from datetime import timedelta

    import torch

    from torchft_tpu_torch._native import LighthouseServer
    from torchft_tpu_torch.collectives import TCPCollective
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.models import Transformer, flagship_config, loss_fn
    from torchft_tpu_torch.parallel import TrainStep

    cfg, batch, seq = flagship_config()
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    data = torch.Generator(device=dev).manual_seed(1516)
    batches = []
    for _ in range(OVERLAP_STEPS):
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=data, device=dev)
        batches.append({"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)})
    run_dir = tempfile.mkdtemp(prefix="tpuft_options_")
    at = {"i": 0}
    runs, closers = {}, []
    try:
        for overlap in (True, False):
            model = Transformer(cfg, device=dev,
                                generator=torch.Generator(device=dev).manual_seed(16))
            opt = torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                                    weight_decay=1e-4)
            lighthouse = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=100)
            closers.append(lighthouse.shutdown)
            metrics = os.path.join(run_dir, f"metrics_{overlap}.jsonl")
            saved = os.environ.get("TPUFT_METRICS_PATH")
            os.environ["TPUFT_METRICS_PATH"] = metrics
            try:
                manager = Manager(
                    collective=TCPCollective(timeout=60.0, host="127.0.0.1"),
                    load_state_dict=lambda sd: None, state_dict=lambda: {},
                    min_replica_size=1, rank=0, world_size=1, replica_id=f"options_{overlap}",
                    lighthouse_addr=lighthouse.address(), store_addr="127.0.0.1",
                    manager_bind="127.0.0.1:0", timeout=timedelta(seconds=60),
                    quorum_timeout=timedelta(seconds=60), init_sync=False)
            finally:
                if saved is None:
                    os.environ.pop("TPUFT_METRICS_PATH", None)
                else:
                    os.environ["TPUFT_METRICS_PATH"] = saved
            closers.insert(0, manager.shutdown)

            def planted(m, b, manager=manager):
                loss = loss_fn(m, b)
                if at["i"] == OVERLAP_FAIL_AT:
                    manager.report_error(RuntimeError("planted failed vote"))
                return loss

            runs[overlap] = {"trainer": TrainStep(model, opt, planted, manager,
                                                  overlap_commit=overlap),
                             "manager": manager, "metrics": metrics, "steps": []}
        for i in range(OVERLAP_STEPS):
            at["i"] = i
            # In turns, the first of each step alternating.
            for overlap in ((True, False) if i % 2 == 0 else (False, True)):
                run = runs[overlap]
                trainer = run["trainer"]
                sync()
                run["manager"].start_quorum()
                t0 = time.perf_counter()
                loss, committed = trainer.ft_step(batches[i])
                loss_v = float(loss)
                sync()
                wall_ms = (time.perf_counter() - t0) * 1e3
                spec = trainer.last_speculation
                rec = {"wall_ms": wall_ms, "loss": loss_v, "committed": committed,
                       "speculated": spec is not None,
                       "restored": bool(spec and spec["restored"]),
                       "snapshot_ms": trainer.snapshot_ms(),
                       "snapshot_bytes": spec["snapshot_bytes"] if spec else 0}
                run["steps"].append(rec)
                if committed != (i != OVERLAP_FAIL_AT):
                    raise AssertionError(f"overlap={overlap}: step {i} committed={committed}")
                if rec["speculated"] != overlap or rec["restored"] != (
                        overlap and i == OVERLAP_FAIL_AT):
                    raise AssertionError(f"overlap={overlap}: step {i} speculation {spec}")
            a, b = (runs[o]["trainer"].state_tensors() for o in (True, False))
            if len(a) != len(b) or not all(x.dtype == y.dtype and torch.equal(x, y)
                                           for x, y in zip(a, b)):
                raise AssertionError(f"step {i}: the overlapped and serial runs' states differ")
            if runs[True]["steps"][-1]["loss"] != runs[False]["steps"][-1]["loss"]:
                raise AssertionError(f"step {i}: the runs' losses differ")
    finally:
        for close in closers:
            close()
        for run in runs.values():
            if os.path.exists(run["metrics"]):
                with open(run["metrics"]) as f:
                    votes = [e["duration_ms"] for e in map(json.loads, f)
                             if e.get("event") == "span" and e.get("phase") == "commit_vote"]
                for rec, vote in zip(run["steps"], votes):
                    rec["commit_vote_ms"] = vote
        shutil.rmtree(run_dir, ignore_errors=True)
    for i in range(OVERLAP_STEPS):
        for overlap in (True, False):
            rec = runs[overlap]["steps"][i]
            snap = ("-" if rec["snapshot_ms"] is None else
                    f"{rec['snapshot_ms']:.3f} ms for {rec['snapshot_bytes'] / 1e9:.3f} GB")
            print(f"  step {i} overlap_commit={overlap}: wall {rec['wall_ms']:.2f} ms, "
                  f"commit_vote {rec.get('commit_vote_ms')} ms, snapshot copy {snap}, committed "
                  f"{rec['committed']}{', state restored' if rec['restored'] else ''} ({card})",
                  flush=True)
    print(f"  overlapped and serial groups bitwise equal (parameters and AdamW state) after "
          f"each of {OVERLAP_STEPS} steps, the failed vote of step {OVERLAP_FAIL_AT} included",
          flush=True)
    return {str(o): runs[o]["steps"] for o in (True, False)}


def step_options_phase(card: str, device: str = "cuda") -> dict:
    t0 = time.monotonic()
    remat = remat_case(card, device)
    overlap = overlap_case(card, device)
    out = {"remat": remat, "overlap": overlap, "phase_s": time.monotonic() - t0, "card": card}
    print("OPTIONS " + json.dumps(out), flush=True)
    print(f"  step options phase: {out['phase_s']:.1f} s ({card})", flush=True)
    return out


# -- phase 16: in-group parallelism and sharded healing on the flagship ----------

# The in-group legs' steps: (a) fsdp 2 and (b) tensor 2 (each's first a
# warm-up), (d) one rank over NCCL.
HSDP_STEPS = {"fsdp": 2, "tensor": 2}
HSDP_NCCL_STEPS = 2
HSDP_LR = 1e-2            # SGD's, every leg
HSDP_RANK_TIMEOUT_S = 300.0
# (c): train_hsdp at the flagship's widths, 2 groups x fsdp 2 on the card;
# group 0's merged commits before group 1's SIGKILL, and the steps both end
# merged past.
HSDP_KILL_AFTER = 3
HSDP_KILL_STEPS = 8
HSDP_KILL_TIMEOUT_S = 300.0
# Sharded against unsharded, both bf16 compute on the same weights and
# batch: a batch split over ranks (a) or heads and partial sums over ranks
# (b) changes cuBLAS's shapes and the summation order, so bf16 rounding
# (2^-9 relative an operation) differs: the mean loss within
# TOL_HSDP_LOSS of its value, each gradient within TOL_HSDP_GRAD of the
# tensor's largest element.  After each step both models take the same SGD
# update, so later steps compare models that differ by those roundings.
TOL_HSDP_LOSS = 5e-3
TOL_HSDP_GRAD = 5e-2


def _hsdp_batch(cfg, batch: int, seq: int, step: int, dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(1600 + step)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=dev)
    return {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}


def hsdp_leg(name: str, sizes: dict, steps: int, rank: int, dev) -> dict:
    """One in-group leg in this rank: the flagship sharded over ``sizes``
    and, in rank 0, the same model unsharded, take the same SGD steps on
    the same batch (each rank its slice); the sharded model's forward and
    backward alone are counted and timed."""
    import torch
    import torch.distributed as dist

    import torchft_tpu_torch.models.transformer as tr
    from torchft_tpu_torch.models import Transformer, flagship_config, parallelize
    from torchft_tpu_torch.ops import launch_counts, reset_launch_counts
    from torchft_tpu_torch.parallel import ft_init_mesh
    from torchft_tpu_torch.parallel.trainer import tree_device_bytes

    cfg, batch, seq = flagship_config()
    world = dist.get_world_size()
    ftmesh = ft_init_mesh(sizes, device_type="cuda")
    model = parallelize(Transformer(cfg, device=dev, generator=torch.Generator(device=dev)
                                    .manual_seed(16)), ftmesh)
    opt = torch.optim.SGD(model.parameters(), lr=HSDP_LR)
    ref = ref_opt = None
    if rank == 0:
        ref = Transformer(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(16))
        ref_opt = torch.optim.SGD(ref.parameters(), lr=HSDP_LR)
    shard, shards = ftmesh.batch_shard()
    vpce = {"calls": 0}
    plain_vpce = tr.vocab_parallel_cross_entropy

    def counted(*a, **k):
        vpce["calls"] += 1
        return plain_vpce(*a, **k)

    tr.vocab_parallel_cross_entropy = counted
    out = {"leg": name, "sizes": sizes, "losses": [], "ref_losses": [], "loss_err": [],
           "grad_err": [], "step_ms": [], "launches": [], "vpce_calls": [],
           "local_param_bytes": tree_device_bytes(list(model.parameters())),
           "global_param_bytes": sum(p.numel() * p.element_size() for p in model.parameters())}
    try:
        for s in range(steps):
            b = _hsdp_batch(cfg, batch, seq, s, dev)
            mine = {k: v.chunk(shards)[shard] for k, v in b.items()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            dist.barrier()
            reset_launch_counts()
            vpce["calls"] = 0
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
            loss = model.loss(mine)
            loss.backward()
            events[1].record()
            events[1].synchronize()
            out["launches"].append(launch_counts())
            out["vpce_calls"].append(vpce["calls"])
            out["step_ms"].append(events[0].elapsed_time(events[1]))
            mean = loss.detach().float().clone()
            dist.all_reduce(mean)
            out["losses"].append(mean.item() / world)
            grads = {n: ftmesh.full_tensor(p.grad) for n, p in model.named_parameters()}
            out["peak_bytes"] = torch.cuda.max_memory_allocated()
            if ref is not None:
                ref_loss = ref.loss(b)
                ref_loss.backward()
                out["ref_losses"].append(ref_loss.item())
                out["loss_err"].append(abs(out["losses"][-1] - ref_loss.item())
                                       / abs(ref_loss.item()))
                errs = {n: float((grads[n] - q.grad).abs().max()
                                 / q.grad.abs().max().clamp_min(1e-30))
                        for n, q in ref.named_parameters()}
                worst = max(errs, key=errs.get)
                out["grad_err"].append(errs[worst])
                out.setdefault("worst_grad", []).append(worst)
                ref_opt.step()
                ref_opt.zero_grad(set_to_none=True)
            opt.step()
            opt.zero_grad(set_to_none=True)
            del grads
    finally:
        tr.vocab_parallel_cross_entropy = plain_vpce
    return out


def run_hsdp_rank(args: argparse.Namespace) -> None:
    """One local rank of phase 16 (a) and (b): the group's world over gloo
    through the slice bootstrap (ranks share the card), then each leg on its
    own mesh over the same ranks; the results go to the run directory."""
    import torch
    import torch.distributed as dist

    from torchft_tpu_torch.multihost import initialize_slice

    rank = args.hsdp_rank
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    initialize_slice(backend="gloo")
    legs = [hsdp_leg("fsdp", {"fsdp": dist.get_world_size()}, HSDP_STEPS["fsdp"], rank, dev),
            hsdp_leg("tensor", {"tensor": dist.get_world_size()}, HSDP_STEPS["tensor"], rank,
                     dev)]
    with open(os.path.join(args.run_dir, f"rank{rank}.json"), "w") as f:
        json.dump(legs, f)
    dist.destroy_process_group()


def hsdp_in_group(card: str) -> dict:
    """Phase 16 (a) and (b): two local ranks on the card, spawned as
    ``chip_smoke.py --hsdp-rank r``, rendezvous through a Store."""
    from torchft_tpu_torch.coordination import StoreServer

    run_dir = tempfile.mkdtemp(prefix="tpuft_hsdp_")
    store = StoreServer(bind="127.0.0.1:0")
    procs = []
    try:
        env = dict(os.environ, TPUFT_NUM_HOSTS="2", TPUFT_STORE=store.address(),
                   TPUFT_COORD_PORT=str(free_port()), MASTER_ADDR="127.0.0.1")
        for r in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--hsdp-rank", str(r),
                 "--run-dir", run_dir], env=dict(env, TPUFT_HOST_RANK=str(r)), cwd=HERE))
        deadline = time.monotonic() + HSDP_RANK_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                raise TimeoutError(f"phase 16: the in-group ranks ran past {HSDP_RANK_TIMEOUT_S} s")
            if any(p.poll() not in (None, 0) for p in procs):
                raise AssertionError(f"phase 16: a rank failed: {[p.poll() for p in procs]}")
            time.sleep(0.1)
        if any(p.returncode != 0 for p in procs):
            raise AssertionError(f"phase 16: a rank failed: {[p.returncode for p in procs]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(run_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        store.shutdown()
        shutil.rmtree(run_dir, ignore_errors=True)
    from torchft_tpu_torch.models import flagship_config

    L = flagship_config()[0].n_layers
    want = {"fsdp": {"flash_fwd": L, "flash_bwd_dkdv": L, "flash_bwd_dq": L, "ce_lse": 1,
                     "ce_dlogits": 1},
            "tensor": {"flash_fwd": L, "flash_bwd_dkdv": L, "flash_bwd_dq": L, "ce_lse": 0,
                       "ce_dlogits": 0}}
    out = {}
    for i, leg in enumerate(("fsdp", "tensor")):
        recs = [ranks[r][i] for r in range(2)]
        head = recs[0]
        for r, rec in enumerate(recs):
            for s, counts in enumerate(rec["launches"]):
                got = {k: counts.get(k, 0) for k in want[leg]}
                if got != want[leg]:
                    raise AssertionError(f"phase 16 ({leg}) rank {r} step {s} launched {got}, "
                                         f"expected {want[leg]}")
            wants_vpce = 1 if leg == "tensor" else 0
            if rec["vpce_calls"] != [wants_vpce] * len(rec["vpce_calls"]):
                raise AssertionError(f"phase 16 ({leg}) rank {r}: vocab-parallel loss calls "
                                     f"{rec['vpce_calls']}, expected {wants_vpce} a step")
        for s, (l, err, gerr) in enumerate(zip(head["losses"], head["loss_err"],
                                               head["grad_err"])):
            if not math.isfinite(l):
                raise AssertionError(f"phase 16 ({leg}) step {s}: loss {l} is not finite")
            if err > TOL_HSDP_LOSS:
                raise AssertionError(f"phase 16 ({leg}) step {s}: loss {l} against the unsharded "
                                     f"{head['ref_losses'][s]}: {err:.3e} > {TOL_HSDP_LOSS}")
            if gerr > TOL_HSDP_GRAD:
                raise AssertionError(f"phase 16 ({leg}) step {s}: a gathered gradient differs "
                                     f"from the unsharded by {gerr:.3e} of its max > "
                                     f"{TOL_HSDP_GRAD}")
        launches = collections.Counter()
        for rec in recs:
            for counts in rec["launches"]:
                launches.update(counts)
        out[leg] = {"losses": head["losses"], "ref_losses": head["ref_losses"],
                    "loss_err": head["loss_err"], "grad_err": head["grad_err"],
                    "worst_grad": head["worst_grad"],
                    "step_ms": [rec["step_ms"] for rec in recs],
                    "peak_bytes": [rec["peak_bytes"] for rec in recs],
                    "local_param_bytes": head["local_param_bytes"],
                    "global_param_bytes": head["global_param_bytes"],
                    "launches": dict(launches)}
        print(f"  ({'a' if leg == 'fsdp' else 'b'}) {leg} 2: losses "
              f"{', '.join(f'{x:.6f}' for x in head['losses'])} against unsharded "
              f"{', '.join(f'{x:.6f}' for x in head['ref_losses'])} (worst {max(head['loss_err']):.2e}"
              f" of it, allowed {TOL_HSDP_LOSS}); gathered gradients within "
              f"{max(head['grad_err']):.2e} of each max (allowed {TOL_HSDP_GRAD}; the worst "
              f"{head['worst_grad']}); forward + "
              f"backward ms a rank {[[round(x, 2) for x in rec['step_ms']] for rec in recs]} "
              f"(CUDA events, the ranks sharing the card; the first a warm-up); peak "
              f"{max(rec['peak_bytes'] for rec in recs) / 2**30:.3f} GiB a rank; parameters "
              f"{head['local_param_bytes'] / 2**20:.1f} of {head['global_param_bytes'] / 2**20:.1f}"
              f" MiB a rank; launches {dict(launches)} ({card})", flush=True)
    return out


def ranked_kill(phase: str, example: str, args: list, steps: int, cap: int, after: int,
                timeout_s: float,
                kernels: tuple = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq", "ce_lse",
                                  "ce_dlogits")) -> dict:
    """A kill drive of an example whose groups are two local ranks each
    (``kill_and_heal``): group 1 SIGKILLed after ``after`` merged commits;
    its ranks must die with it and each restarted rank heal from group 0's
    same rank.  Returns the drive's result with each rank's heal spans and
    heal line and the launches the ranks logged; raises for ``phase`` if a
    rank did not heal or one of ``kernels`` (the example's path's) never
    launched."""
    from torchft_tpu_torch.examples.kill_heal import kill_and_heal

    log_dir = tempfile.mkdtemp(prefix="tpuft_ranked_kill_")
    try:
        r = kill_and_heal("cuda", log_dir, steps=steps, steps_cap=cap, merged_before_kill=after,
                          timeout_s=timeout_s, example=example, args=args)
        heals, launches, healed = {}, collections.Counter(), {}
        for rank in (0, 1):
            path = r["metrics_path"] + (f".rank{rank}" if rank else "")
            with open(path) as f:
                evs = [json.loads(line) for line in f if line.strip()]
            heals[rank] = [e["duration_ms"] for e in evs if e.get("event") == "span"
                           and e.get("phase") == "heal" and e.get("replica_id", "").startswith("1:")
                           and e.get("step", 0) > 0]
        # The ranks share their group's log; each line is one write.
        counted = re.compile(r"\[group \d+ rank \d+\] kernel launches (\{[^{}]*\})")
        heal_line = re.compile(r"\[group 1 rank (\d+)\] healed step=(\d+) bytes=(\d+) "
                               r"fetch_s=([0-9.]+)(?: stage=(\d+))?")
        for g in (0, 1):
            with open(os.path.join(log_dir, f"g{g}.log"), errors="replace") as f:
                text = f.read()
            for m in counted.finditer(text):
                launches.update(json.loads(m[1]))
            for m in heal_line.finditer(text):
                if int(m[2]) > 0:
                    healed[int(m[1])] = {"step": int(m[2]), "bytes": int(m[3]),
                                         "fetch_s": float(m[4]),
                                         **({"stage": int(m[5])} if m[5] else {})}
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    if sorted(healed) != [0, 1] or not all(heals[k] for k in (0, 1)):
        raise AssertionError(f"{phase}: not every rank of group 1 healed: {healed}, "
                             f"heal spans {heals}")
    missing = [k for k in kernels if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"{phase}: no launch of {missing}")
    return {"final_step": r["final_step"], "params_sha256": r["params_sha256"],
            "killed_rank_pids": r["killed_rank_pids"], "recovery_s": r["recovery_s"],
            "kill_to_heal_line_s": r["kill_to_heal_line_s"],
            "merged_step_ms": r["survivor_merged_step_ms"],
            "solo_step_ms": r["survivor_solo_step_ms"], "heal_ms": heals, "healed": healed,
            "launches": dict(launches)}


def hsdp_kill(card: str) -> dict:
    """Phase 16 (c): train_hsdp at the flagship's widths under the launcher,
    two groups of two ranks ({fsdp 2}, gloo on the shared card), group 1
    SIGKILLed after HSDP_KILL_AFTER merged commits; its ranks must die with
    it and each heal its shards over HTTP from group 0's same rank."""
    out = ranked_kill("phase 16 (c)", "train_hsdp",
                      ["--model", "flagship", "--devices", "2", "--fsdp", "2", "--tensor", "1",
                       "--batch", "16"], HSDP_KILL_STEPS, HSDP_KILL_STEPS + 40, HSDP_KILL_AFTER,
                      HSDP_KILL_TIMEOUT_S)
    print(f"  (c) 2 groups x fsdp 2, group 1 SIGKILLed: its ranks {out['killed_rank_pids']} gone; "
          f"each rank healed its shards (heal span ms {out['heal_ms']}; fetched "
          f"{ {k: (v['bytes'], v['fetch_s']) for k, v in out['healed'].items()} } bytes, s); "
          f"kill -> first merged commit {out['recovery_s']:.3f} s; merged step "
          f"{out['merged_step_ms']:.1f} ms, solo {out['solo_step_ms'] or 0:.1f} ms "
          f"(group 0's rank 0, host clock); both groups end at step {out['final_step']} with "
          f"params_sha256 {out['params_sha256'][:16]}...; launches {out['launches']} ({card})",
          flush=True)
    return out


def hsdp_nccl(card: str) -> dict:
    """Phase 16 (d): one group on a one-rank mesh over NCCL, the deployment's
    own backend, in this process: the flagship's parameters as DTensors, a
    lone Manager, HSDP_NCCL_STEPS ft_steps, the loss all-reduced over the
    group's NCCL world."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from torchft_tpu_torch._native import LighthouseServer
    from torchft_tpu_torch.collectives import TCPCollective
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.models import Transformer, flagship_config, loss_fn, parallelize
    from torchft_tpu_torch.ops import launch_counts, reset_launch_counts
    from torchft_tpu_torch.parallel import TrainStep, ft_init_mesh

    cfg, batch, seq = flagship_config()
    dev = torch.device("cuda", 0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
                            rank=0, device_id=dev)
    lighthouse = manager = None
    try:
        backend = dist.get_backend()
        ftmesh = ft_init_mesh({"fsdp": 1}, device_type="cuda")
        model = parallelize(Transformer(cfg, device=dev, generator=torch.Generator(device=dev)
                                        .manual_seed(16)), ftmesh)
        kinds = sorted({type(p).__name__ for p in model.parameters()})
        lighthouse = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=100)
        manager = Manager(
            collective=TCPCollective(timeout=60.0, host="127.0.0.1"),
            load_state_dict=lambda sd: None, state_dict=lambda: {}, min_replica_size=1, rank=0,
            world_size=1, replica_id="hsdp_nccl", lighthouse_addr=lighthouse.address(),
            store_addr="127.0.0.1", manager_bind="127.0.0.1:0", timeout=timedelta(seconds=60),
            quorum_timeout=timedelta(seconds=60), init_sync=False)
        ftmesh.manager = manager
        trainer = TrainStep(model, torch.optim.SGD(model.parameters(), lr=HSDP_LR), loss_fn,
                            manager, overlap_commit=False)
        losses, launches = [], collections.Counter()
        for s in range(HSDP_NCCL_STEPS):
            b = _hsdp_batch(cfg, batch, seq, s, dev)
            manager.start_quorum()
            torch.cuda.synchronize()
            reset_launch_counts()
            loss, committed = trainer.ft_step(b)
            torch.cuda.synchronize()
            launches.update(launch_counts())
            mean = loss.detach().float().clone()
            dist.all_reduce(mean)
            losses.append(mean.item())
            if not committed or not math.isfinite(losses[-1]):
                raise AssertionError(f"phase 16 (d) step {s}: committed {committed}, "
                                     f"loss {losses[-1]}")
    finally:
        if manager is not None:
            manager.shutdown()
        if lighthouse is not None:
            lighthouse.shutdown()
        dist.destroy_process_group()
    L = cfg.n_layers
    want = {"flash_fwd": L, "flash_bwd_dkdv": L, "flash_bwd_dq": L, "ce_lse": 1, "ce_dlogits": 1}
    got = {k: launches.get(k, 0) for k in want}
    if got != {k: v * HSDP_NCCL_STEPS for k, v in want.items()} or kinds != ["DTensor"]:
        raise AssertionError(f"phase 16 (d): launches {got}, parameters {kinds}")
    print(f"  (d) one rank over {backend}: {HSDP_NCCL_STEPS} committed ft_steps, losses "
          f"{losses}, parameters {kinds}, launches {got} ({card})", flush=True)
    return {"backend": backend, "losses": losses, "launches": dict(launches)}


def hsdp_phase(card: str, kill: dict) -> dict:
    """Phase 16: (a), (b) and (d) here; ``kill``: (c)'s result
    (:func:`hsdp_kill`, run earlier beside another phase, its launches
    counted in its own processes)."""
    t0 = time.monotonic()
    out = hsdp_in_group(card)
    out["nccl"] = hsdp_nccl(card)
    out["kill"] = kill
    out["phase_s"] = time.monotonic() - t0
    launches = collections.Counter()
    for leg in ("fsdp", "tensor"):
        launches.update(out[leg]["launches"])
    launches.update(out["kill"]["launches"])
    launches.update(out["nccl"]["launches"])
    out["launches"] = dict(launches)
    out["card"] = card
    print("HSDP " + json.dumps(out), flush=True)
    print(f"  in-group phase: {out['phase_s']:.1f} s ({card})", flush=True)
    return out


# -- phase 17: the mixture of experts and the pipeline on the flagship's widths ---

# (a): the flagship's widths with each block's MLP a mixture of 8 experts
# (d_ff 2048 an expert, top 2, capacity factor 1.25, aux 0.01: the JAX
# defaults), about 530M parameters.  A group's batch is 8, cut from 16:
# the dense dispatch and combine are [T, 8, C] f32, 0.67 GB each a layer at
# T 8192 (C 2568) and 2.69 GB at batch 16 (C 5128), with two ranks and the
# unsharded model sharing the card.
MOE_EXPERTS = 8
MOE_BATCH = 8
MOE_STEPS = 2             # bf16 passes, sharded against unsharded (the first a warm-up)
MOE_F32_BATCH = 2         # the f32 pass's batch (f32 activations take twice the bytes)
MOE_FT_STEPS = 2          # committed ft_steps of TrainStep under a Manager
# (b): the flagship unchanged (12 layers, batch 16) over {pipeline 2}.
PIPE_MICRO = 4            # microbatches of the parity steps
PIPE_STEPS = 2            # each schedule's steps on the same weights (the first a warm-up)
PIPE_MEM_MICRO = 8        # microbatches of the peak-memory step of each schedule
P17_LR = 1e-2
P17_RANK_TIMEOUT_S = 420.0
# (c): train_pipeline --model flagship --schedule 1f1b, 2 groups x {pipeline
# 2} on the card; group 0's merged commits before group 1's SIGKILL, and the
# steps both end merged past.
P17_KILL_AFTER = 3
P17_KILL_STEPS = 8
# The survivor's step bound while it waits for the restarted group (whose
# start, build and heal take tens of seconds) to merge back.
P17_KILL_CAP = 160
P17_KILL_TIMEOUT_S = 360.0
# Sharded against unsharded, both bf16 compute: the tolerances of phase 16
# (TOL_HSDP_*), for the same reason, on the loss and every gradient.  The
# unsharded MoE takes the sharded run's routing: routing is discrete, and a
# product summed in another order (each rank's experts' share, then the sum
# over "expert") moves a few outputs by an ulp, which can send near-tied
# tokens to another expert in later layers and move the gradients by 12-20%
# of their max (on an H100 80GB HBM3 at 700 W, with an extra rounding a
# rank: up to 170 of 8192 tokens a layer, PERF.md section 6).  Those tokens
# are counted and held to TOL_P17_REROUTE of a layer's tokens (a wrong
# shard or gate sends most tokens elsewhere).  In f32 the same
# reassociation moves values by about 1e-7 and routes no token otherwise:
# there the loss is held within TOL_P17_F32_LOSS of its value and each
# gathered gradient within TOL_P17_F32_GRAD of its tensor's max (f32 sums
# of a few thousand terms reassociated: about 1e-6; a wrong shard or a lost
# sum moves them by their own size).
TOL_P17_LOSS = TOL_HSDP_LOSS
TOL_P17_GRAD = TOL_HSDP_GRAD
TOL_P17_REROUTE = 0.05
TOL_P17_F32_LOSS = 1e-5
TOL_P17_F32_GRAD = 1e-3


def moe_config():
    """The flagship's widths, depth and sequence with the MoE MLP."""
    import dataclasses

    from torchft_tpu_torch.models import flagship_config

    cfg, _, seq = flagship_config()
    return dataclasses.replace(cfg, moe_experts=MOE_EXPERTS), MOE_BATCH, seq


def _grad_errs(got: dict, want: dict) -> dict:
    return {n: float((got[n].float() - g.float()).abs().max()
                     / g.float().abs().max().clamp_min(1e-30)) for n, g in want.items()}


def _timed(fn) -> tuple:
    """fn() between CUDA events, the launch counts set to 0 just before and
    the allocator's peak reset: (result, ms, launches, peak bytes)."""
    import torch

    from torchft_tpu_torch.ops import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    events[0].record()
    out = fn()
    events[1].record()
    events[1].synchronize()
    return out, events[0].elapsed_time(events[1]), launch_counts(), torch.cuda.max_memory_allocated()


def _moe_passes(cfg, batch: int, seq: int, passes: int, seed: int, rank: int, dev) -> tuple:
    """``passes`` forward and backward passes of the MoE model over {expert
    2} and, in rank 0, of the same model unsharded, on one set of weights,
    each pass on a batch of its own (the group's, replicated over "expert").
    The unsharded model takes the sharded one's routing (each Block's
    ``moe_route``), so their losses and gradients differ by rounding alone;
    the tokens its own router would send elsewhere are counted.  No update
    between passes.  Returns (the sharded model, its mesh, the records)."""
    import torch
    import torch.distributed as dist

    from torchft_tpu_torch.models import Transformer, parallelize
    from torchft_tpu_torch.parallel import ft_init_mesh
    from torchft_tpu_torch.parallel.trainer import tree_device_bytes

    ftmesh = ft_init_mesh({"expert": dist.get_world_size()}, device_type="cuda")
    model = parallelize(Transformer(cfg, device=dev, generator=torch.Generator(device=dev)
                                    .manual_seed(17)), ftmesh)
    ref = None
    if rank == 0:
        ref = Transformer(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(17))
    out = {"batch": batch, "losses": [], "ref_losses": [], "loss_err": [], "grad_err": [],
           "worst_grads": [], "step_ms": [], "launches": [], "peak_bytes": [], "dropped": [],
           "rerouted": [], "choices": 0, "tokens": 0,
           "local_param_bytes": tree_device_bytes(list(model.parameters())),
           "global_param_bytes": sum(p.numel() * p.element_size() for p in model.parameters())}

    def recording(m):
        records = [[] for _ in m.layers]
        for layer, rec in zip(m.layers, records):
            layer.moe_record = rec
        return records

    for s in range(passes):
        b = _hsdp_batch(cfg, batch, seq, seed + s, dev)
        records = recording(model)
        dist.barrier()

        def step():
            loss = model.loss(b)
            loss.backward()
            return loss

        loss, ms, counts, peak = _timed(step)
        out["step_ms"].append(ms)
        out["launches"].append(counts)
        out["peak_bytes"].append(peak)
        out["losses"].append(loss.item())
        out["dropped"].append(sum(int((~r[0]["kept"]).sum()) for r in records))
        out["choices"] = sum(r[0]["kept"].numel() for r in records)
        out["tokens"] = records[0][0]["kept"].shape[0]
        grads = {n: ftmesh.full_tensor(p.grad) for n, p in model.named_parameters()}
        if ref is not None:
            ref_records = recording(ref)
            for layer, rec in zip(ref.layers, records):
                layer.moe_route = rec[0]["gate_idx"]
            ref_loss = ref.loss(b)
            ref_loss.backward()
            out["ref_losses"].append(ref_loss.item())
            out["loss_err"].append(abs(loss.item() - ref_loss.item()) / abs(ref_loss.item()))
            # Tokens whose unsharded router would pick another expert, a layer.
            out["rerouted"].append([int((r[0]["own_idx"] != r[0]["gate_idx"]).any(-1).sum())
                                    for r in ref_records])
            errs = _grad_errs(grads, {n: q.grad for n, q in ref.named_parameters()})
            worst = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
            out["grad_err"].append(worst[0][1])
            out["worst_grads"].append(worst)
            ref.zero_grad(set_to_none=True)
        model.zero_grad(set_to_none=True)
        del grads
    for m in (model, ref):
        for layer in m.layers if m is not None else ():
            layer.moe_record = layer.moe_route = None
    del ref
    torch.cuda.empty_cache()
    return model, ftmesh, out


def moe_leg(rank: int, dev, manager) -> dict:
    """Phase 17 (a) in this rank: the MoE model sharded against unsharded,
    in f32 (the plain path, batch MOE_F32_BATCH) and in bf16 (the kernels,
    batch MOE_BATCH, MOE_STEPS passes); then MOE_FT_STEPS ft_steps of the
    bf16 model under the rank's Manager."""
    import dataclasses

    import torch

    from torchft_tpu_torch.models import loss_fn
    from torchft_tpu_torch.parallel import TrainStep

    cfg, batch, seq = moe_config()
    model, _, f32 = _moe_passes(dataclasses.replace(cfg, dtype=torch.float32), MOE_F32_BATCH,
                                seq, 1, 169, rank, dev)
    del model
    torch.cuda.empty_cache()
    model, _, out = _moe_passes(cfg, batch, seq, MOE_STEPS, 170, rank, dev)
    out["f32"] = f32
    # Committed ft_steps of the sharded model under this rank's Manager.
    opt = torch.optim.SGD(model.parameters(), lr=P17_LR)
    trainer = TrainStep(model, opt, loss_fn, manager, overlap_commit=False)
    out["ft"] = []
    for s in range(MOE_FT_STEPS):
        b = _hsdp_batch(cfg, batch, seq, 175 + s, dev)
        manager.start_quorum()
        (loss, committed), ms, counts, _ = _timed(lambda: trainer.ft_step(b))
        out["ft"].append({"loss": loss.item(), "committed": committed, "ms": ms,
                          "launches": counts})
    del model, opt, trainer
    torch.cuda.empty_cache()
    return out


def pipe_leg(rank: int, dev) -> dict:
    """Phase 17 (b) in this rank: its stage of the flagship over {pipeline
    2} under GPipe and 1F1B (PIPE_STEPS steps each on the same weights and
    batch, M PIPE_MICRO), against the unsharded flagship's loss and
    gradients, which every rank computes; then each schedule's peak at M
    PIPE_MEM_MICRO."""
    import torch
    import torch.distributed as dist

    from torchft_tpu_torch.models import Transformer, flagship_config
    from torchft_tpu_torch.parallel import (
        ft_init_mesh,
        pipeline_1f1b_value_and_grad,
        pipeline_loss_fn,
        pipeline_stage,
    )
    from torchft_tpu_torch.parallel import pipeline as pl

    cfg, batch, seq = flagship_config()
    ftmesh = ft_init_mesh({"pipeline": dist.get_world_size()}, device_type="cuda")
    b = _hsdp_batch(cfg, batch, seq, 171, dev)
    ref = Transformer(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(17))
    ref_loss = ref.loss(b)
    ref_loss.backward()
    ref_grads = {n: p.grad for n, p in ref.named_parameters()}
    del ref
    model = pipeline_stage(Transformer(cfg, device=dev, generator=torch.Generator(device=dev)
                                       .manual_seed(17)), ftmesh)
    lo = model.stage[2].start

    def global_name(name: str) -> str:
        parts = name.split(".")
        if parts[0] == "layers":
            parts[1] = str(lo + int(parts[1]))
        return ".".join(parts)

    def run(schedule: str, micro: int):
        if schedule == "gpipe":
            loss = pipeline_loss_fn(model, b, ftmesh, num_microbatches=micro)
            loss.backward()
            return loss.detach()
        return pipeline_1f1b_value_and_grad(model, b, ftmesh, num_microbatches=micro)

    out = {"ref_loss": ref_loss.item(), "stage": model.stage[0],
           "layers": list(model.stage[2])}
    for schedule in ("gpipe", "1f1b"):
        rec = out[schedule] = {"losses": [], "loss_err": [], "grad_err": [], "worst_grad": [],
                               "step_ms": [], "launches": []}
        for _ in range(PIPE_STEPS):
            model.zero_grad(set_to_none=True)
            dist.barrier()
            loss, ms, counts, _ = _timed(lambda: run(schedule, PIPE_MICRO))
            rec["losses"].append(loss.item())
            rec["loss_err"].append(abs(loss.item() - ref_loss.item()) / abs(ref_loss.item()))
            errs = _grad_errs({global_name(n): p.grad for n, p in model.named_parameters()},
                              {global_name(n): ref_grads[global_name(n)]
                               for n, _ in model.named_parameters()})
            worst = max(errs, key=errs.get)
            rec["grad_err"].append(errs[worst])
            rec["worst_grad"].append(worst)
            rec["step_ms"].append(ms)
            rec["launches"].append(counts)
        rec["schedule"] = dict(pl.last_schedule)
    del ref_grads, ref_loss
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    # Peak a rank at M PIPE_MEM_MICRO: the resident stage, then one step.
    out["resident_bytes"] = torch.cuda.memory_allocated()
    for schedule in ("gpipe", "1f1b"):
        dist.barrier()
        _, ms, counts, peak = _timed(lambda: run(schedule, PIPE_MEM_MICRO))
        out[f"peak_{schedule}"] = peak
        out[f"mem_ms_{schedule}"] = ms
        out[f"mem_held_{schedule}"] = pl.last_schedule["max_held"]
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
    return out


def run_p17_rank(args: argparse.Namespace) -> None:
    """One local rank of phase 17 (a) and (b), then of phase 19's legs: the
    rank's Manager (which hosts the group's store on rank 0, as
    train_hsdp's ranks do), the group's world over gloo through the slice
    bootstrap (ranks share the card), then each leg on its own mesh; the
    results go to the run directory."""
    import torch
    import torch.distributed as dist

    from torchft_tpu_torch.examples._common import make_manager
    from torchft_tpu_torch.multihost import initialize_slice

    rank = args.p17_rank
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    manager = make_manager(lambda: {}, lambda sd: None, 0, rank=rank, world_size=2,
                           store_port=int(os.environ["MASTER_PORT"]), init_sync=False,
                           timeout_s=120.0)
    try:
        initialize_slice(backend="gloo")
        out = {"moe": moe_leg(rank, dev, manager), "pipe": pipe_leg(rank, dev)}
        out["p19"] = p19_legs(rank, dev, manager)
    finally:
        manager.shutdown()
    with open(os.path.join(args.run_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def p17_start() -> dict:
    """Starts phase 17 (a) and (b): two local ranks on the card, spawned as
    ``chip_smoke.py --p17-rank r``, each with its Manager on a lighthouse
    of this process.  :func:`p17_finish` waits for them."""
    from torchft_tpu_torch._native import LighthouseServer

    run = {"dir": tempfile.mkdtemp(prefix="tpuft_p17_"), "procs": [], "t0": time.monotonic(),
           "lighthouse": LighthouseServer(bind="127.0.0.1:0", min_replicas=1,
                                          join_timeout_ms=100)}
    try:
        port = free_port()
        env = dict(os.environ, TPUFT_NUM_HOSTS="2", TPUFT_STORE=f"127.0.0.1:{port}",
                   MASTER_PORT=str(port), TPUFT_COORD_PORT=str(free_port()),
                   MASTER_ADDR="127.0.0.1", TPUFT_LIGHTHOUSE=run["lighthouse"].address())
        for r in range(2):
            run["procs"].append(subprocess.Popen(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--p17-rank", str(r),
                 "--run-dir", run["dir"]], env=dict(env, TPUFT_HOST_RANK=str(r)), cwd=HERE))
    except BaseException:
        _p17_stop(run)
        raise
    return run


def _p17_stop(run: dict) -> None:
    if run.get("stopped"):
        return
    run["stopped"] = True
    for p in run["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait()
    run["lighthouse"].shutdown()
    shutil.rmtree(run["dir"], ignore_errors=True)


def p17_wait(run: dict) -> None:
    """Waits until :func:`p17_start`'s ranks have exited; raises if one
    failed or they ran past P17_RANK_TIMEOUT_S."""
    procs = run["procs"]
    deadline = run["t0"] + P17_RANK_TIMEOUT_S
    while any(p.poll() is None for p in procs):
        if time.monotonic() > deadline:
            raise TimeoutError(f"phase 17: the in-group ranks ran past {P17_RANK_TIMEOUT_S} s")
        if any(p.poll() not in (None, 0) for p in procs):
            raise AssertionError(f"phase 17: a rank failed: {[p.poll() for p in procs]}")
        time.sleep(0.1)
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"phase 17: a rank failed: {[p.returncode for p in procs]}")
    run.setdefault("wall", time.monotonic() - run["t0"])


def p17_finish(run: dict, card: str) -> dict:
    """Waits for :func:`p17_start`'s ranks, stops what it started, and holds
    their records (:func:`moe_checks`, :func:`pipe_checks`)."""
    try:
        p17_wait(run)
        ranks = []
        for r in range(2):
            with open(os.path.join(run["dir"], f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        _p17_stop(run)
    wall = run["wall"]
    run["p19"] = [r["p19"] for r in ranks]  # phase 19 holds them
    out = {"moe": moe_checks(card, [r["moe"] for r in ranks]),
           "pipe": pipe_checks(card, [r["pipe"] for r in ranks]), "ranks_s": wall}
    print(f"  (a) and (b), then phase 19's legs: {wall:.1f} s from the ranks' start to their "
          f"results ({card})", flush=True)
    return out


def _kernel_counts(counts: dict) -> dict:
    return {k: counts.get(k, 0) for k in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq",
                                          "ce_lse", "ce_dlogits")}


def moe_checks(card: str, recs: list) -> dict:
    """Prints (a)'s numbers, then holds them: K1-K5 12 / 12 / 12 / 1 / 1 a
    rank a bf16 pass and ft_step, none in f32 (the plain path); the f32
    loss and every gathered f32 gradient against the unsharded, no token
    routed otherwise; the bf16 loss and every gathered bf16 gradient, the
    tokens routed otherwise a layer; committed ft_steps, finite losses."""
    L = moe_config()[0].n_layers
    want = {"flash_fwd": L, "flash_bwd_dkdv": L, "flash_bwd_dq": L, "ce_lse": 1, "ce_dlogits": 1}
    head, f32 = recs[0], recs[0]["f32"]
    launches = collections.Counter()
    for rec in recs:
        for counts in rec["launches"] + [f["launches"] for f in rec["ft"]]:
            launches.update(counts)
    out = {"losses": head["losses"], "ref_losses": head["ref_losses"],
           "loss_err": head["loss_err"], "grad_err": head["grad_err"],
           "worst_grads": head["worst_grads"], "dropped": head["dropped"],
           "rerouted": head["rerouted"], "tokens": head["tokens"],
           "choices": head["choices"], "f32": {k: f32[k] for k in (
               "losses", "ref_losses", "loss_err", "grad_err", "worst_grads", "dropped",
               "rerouted", "step_ms", "batch")},
           "step_ms": [rec["step_ms"] for rec in recs],
           "peak_bytes": [rec["peak_bytes"] for rec in recs],
           "ft": [[f["ms"] for f in rec["ft"]] for rec in recs],
           "ft_losses": [f["loss"] for f in head["ft"]],
           "local_param_bytes": head["local_param_bytes"],
           "global_param_bytes": head["global_param_bytes"], "launches": dict(launches)}
    print(f"  (a) MoE {MOE_EXPERTS} experts over expert 2, f32 (plain path), batch "
          f"{MOE_F32_BATCH}: loss {f32['losses'][0]:.6f} against unsharded "
          f"{f32['ref_losses'][0]:.6f} ({f32['loss_err'][0]:.2e} of it, allowed "
          f"{TOL_P17_F32_LOSS}); gathered gradients within {f32['grad_err'][0]:.2e} of each max "
          f"(allowed {TOL_P17_F32_GRAD}; the worst {f32['worst_grads'][0]}); tokens routed "
          f"otherwise a layer {f32['rerouted'][0]}; choices dropped {f32['dropped'][0]} of "
          f"{f32['choices']} ({card})", flush=True)
    print(f"  (a) bf16 (the kernels), batch {MOE_BATCH}: losses "
          f"{', '.join(f'{x:.6f}' for x in head['losses'])} against unsharded "
          f"{', '.join(f'{x:.6f}' for x in head['ref_losses'])} (worst {max(head['loss_err']):.2e} of "
          f"it, allowed {TOL_P17_LOSS}); gathered gradients within {head['grad_err']} of each max "
          f"(allowed {TOL_P17_GRAD}; the worst {head['worst_grads']}), the unsharded model on "
          f"the sharded routing; tokens its own router sends elsewhere, a layer, "
          f"{head['rerouted']} of {head['tokens']} (allowed "
          f"{int(TOL_P17_REROUTE * head['tokens'])}); choices dropped {head['dropped']} of "
          f"{head['choices']}; forward + backward ms a rank "
          f"{[[round(x, 2) for x in rec['step_ms']] for rec in recs]} (CUDA events, the ranks "
          f"sharing the card; the first a warm-up); peak "
          f"{[round(max(rec['peak_bytes']) / 2**30, 3) for rec in recs]} GiB a rank (rank 0 also "
          f"holds the unsharded model); parameters {head['local_param_bytes'] / 2**20:.1f} of "
          f"{head['global_param_bytes'] / 2**20:.1f} MiB a rank; {MOE_FT_STEPS} committed "
          f"ft_steps, losses {out['ft_losses']}, ms a rank {out['ft']}; launches "
          f"{dict(launches)} ({card})", flush=True)
    for r, rec in enumerate(recs):
        for s, counts in enumerate(rec["launches"] + [f["launches"] for f in rec["ft"]]):
            if _kernel_counts(counts) != want:
                raise AssertionError(f"phase 17 (a) rank {r} step {s} launched "
                                     f"{_kernel_counts(counts)}, expected {want}")
        if any(rec["f32"]["launches"][0].get(k, 0) for k in want):
            raise AssertionError(f"phase 17 (a) rank {r}: the f32 pass launched "
                                 f"{rec['f32']['launches'][0]}, expected the plain path")
        for s, f in enumerate(rec["ft"]):
            if not f["committed"] or not math.isfinite(f["loss"]):
                raise AssertionError(f"phase 17 (a) rank {r} ft_step {s}: committed "
                                     f"{f['committed']}, loss {f['loss']}")
        if rec["losses"] != head["losses"] or rec["f32"]["losses"] != f32["losses"]:
            raise AssertionError("phase 17 (a): the expert ranks' losses differ")
    if any(f32["rerouted"][0]):
        raise AssertionError(f"phase 17 (a) f32: tokens routed otherwise {f32['rerouted'][0]}")
    if f32["loss_err"][0] > TOL_P17_F32_LOSS or f32["grad_err"][0] > TOL_P17_F32_GRAD:
        raise AssertionError(f"phase 17 (a) f32: loss {f32['loss_err'][0]:.3e} (allowed "
                             f"{TOL_P17_F32_LOSS}), gradient {f32['grad_err'][0]:.3e} (allowed "
                             f"{TOL_P17_F32_GRAD})")
    for s, (l, err, gerr) in enumerate(zip(head["losses"], head["loss_err"], head["grad_err"])):
        if not math.isfinite(l) or err > TOL_P17_LOSS:
            raise AssertionError(f"phase 17 (a) step {s}: loss {l} against the unsharded "
                                 f"{head['ref_losses'][s]}: {err:.3e} > {TOL_P17_LOSS}")
        if gerr > TOL_P17_GRAD:
            raise AssertionError(f"phase 17 (a) step {s}: gradient {head['worst_grads'][s][0]} "
                                 f"differs from the unsharded by {gerr:.3e} of its max > "
                                 f"{TOL_P17_GRAD}")
        if max(head["rerouted"][s]) > TOL_P17_REROUTE * head["tokens"]:
            raise AssertionError(f"phase 17 (a) step {s}: tokens routed otherwise a layer "
                                 f"{head['rerouted'][s]} of {head['tokens']} > {TOL_P17_REROUTE}")
    return out


def pipe_checks(card: str, recs: list) -> dict:
    """Prints (b)'s numbers, then holds them: each schedule's launches a
    stage a step, its loss and every gradient of the stage against the
    unsharded model's, and 1F1B's peak below GPipe's at M PIPE_MEM_MICRO."""
    from torchft_tpu_torch.models import flagship_config

    per = flagship_config()[0].n_layers // 2
    M = PIPE_MICRO
    want = {"gpipe": [{"flash_fwd": per * M, "flash_bwd_dkdv": per * M, "flash_bwd_dq": per * M,
                       "ce_lse": int(s == 1), "ce_dlogits": int(s == 1)} for s in (0, 1)],
            "1f1b": [{"flash_fwd": 2 * per * M, "flash_bwd_dkdv": per * M,
                      "flash_bwd_dq": per * M, "ce_lse": M * int(s == 1),
                      "ce_dlogits": M * int(s == 1)} for s in (0, 1)]}
    recs = sorted(recs, key=lambda rec: rec["stage"])
    launches = collections.Counter()
    out = {"resident_bytes": [rec["resident_bytes"] for rec in recs]}
    for schedule in ("gpipe", "1f1b"):
        for rec in recs:
            for counts in rec[schedule]["launches"]:
                launches.update(counts)
        o = out[schedule] = {
            "losses": recs[0][schedule]["losses"],
            "loss_err": max(max(rec[schedule]["loss_err"]) for rec in recs),
            "grad_err": max(max(rec[schedule]["grad_err"]) for rec in recs),
            "worst_grad": [rec[schedule]["worst_grad"] for rec in recs],
            "step_ms": [rec[schedule]["step_ms"] for rec in recs],
            "launches": [rec[schedule]["launches"][-1] for rec in recs],
            "peak_bytes": [rec[f"peak_{schedule}"] for rec in recs],
            "mem_ms": [rec[f"mem_ms_{schedule}"] for rec in recs],
            "held": [rec[f"mem_held_{schedule}"] for rec in recs]}
        print(f"  (b) {schedule} over pipeline 2, M {M}: losses "
              f"{', '.join(f'{x:.6f}' for x in o['losses'])} against unsharded "
              f"{recs[0]['ref_loss']:.6f} (worst {o['loss_err']:.2e}, allowed {TOL_P17_LOSS}); "
              f"gradients within {o['grad_err']:.2e} of each max (allowed {TOL_P17_GRAD}; the "
              f"worst {o['worst_grad']}); forward + backward ms a stage "
              f"{[[round(x, 2) for x in ms] for ms in o['step_ms']]} (CUDA events, the first a "
              f"warm-up); launches a stage a step {[_kernel_counts(c) for c in o['launches']]}; "
              f"at M {PIPE_MEM_MICRO}: peak {[round(p / 2**30, 3) for p in o['peak_bytes']]} GiB a "
              f"stage over resident {[round(p / 2**30, 3) for p in out['resident_bytes']]}, "
              f"microbatches held at once {o['held']}, ms {[round(x, 2) for x in o['mem_ms']]} "
              f"({card})", flush=True)
    out["launches"] = dict(launches)
    for schedule in ("gpipe", "1f1b"):
        for rec in recs:
            r, s = rec[schedule], rec["stage"]
            for i, counts in enumerate(r["launches"]):
                if _kernel_counts(counts) != want[schedule][s]:
                    raise AssertionError(f"phase 17 (b) {schedule} stage {s} step {i} launched "
                                         f"{_kernel_counts(counts)}, expected {want[schedule][s]}")
            for i, (l, err, gerr) in enumerate(zip(r["losses"], r["loss_err"], r["grad_err"])):
                if not math.isfinite(l) or err > TOL_P17_LOSS:
                    raise AssertionError(f"phase 17 (b) {schedule} stage {s} step {i}: loss {l} "
                                         f"against the unsharded {rec['ref_loss']}: {err:.3e} > "
                                         f"{TOL_P17_LOSS}")
                if gerr > TOL_P17_GRAD:
                    raise AssertionError(f"phase 17 (b) {schedule} stage {s} step {i}: gradient "
                                         f"{r['worst_grad'][i]} differs from the unsharded by "
                                         f"{gerr:.3e} of its max > {TOL_P17_GRAD}")
    for rec in recs:
        if not rec["peak_1f1b"] < rec["peak_gpipe"]:
            raise AssertionError(f"phase 17 (b) stage {rec['stage']}: 1F1B's peak "
                                 f"{rec['peak_1f1b']} is not below GPipe's {rec['peak_gpipe']} "
                                 f"at M {PIPE_MEM_MICRO}")
    return out


def p17_kill(card: str) -> dict:
    """Phase 17 (c): train_pipeline --model flagship --schedule 1f1b under
    the launcher, two groups of {pipeline 2} (gloo on the shared card),
    group 1 SIGKILLed after P17_KILL_AFTER merged commits: its ranks die
    with it, each restarted rank heals its own stage over HTTP from group
    0's same rank, and both groups end with one params_sha256."""
    out = ranked_kill("phase 17 (c)", "train_pipeline",
                      ["--model", "flagship", "--devices", "2", "--pipe", "2", "--schedule",
                       "1f1b", "--batch", "16", "--microbatches", str(PIPE_MICRO)],
                      P17_KILL_STEPS, P17_KILL_CAP, P17_KILL_AFTER, P17_KILL_TIMEOUT_S)
    print(f"  (c) train_pipeline 1f1b, 2 groups x pipeline 2, group 1 SIGKILLed: its ranks "
          f"{out['killed_rank_pids']} gone; each rank healed its stage (heal span ms {out['heal_ms']}; "
          f"fetched { {k: (v['stage'], v['bytes'], v['fetch_s']) for k, v in out['healed'].items()} } "
          f"stage, bytes, s); kill -> first merged commit {out['recovery_s']:.3f} s; merged step "
          f"{out['merged_step_ms']:.1f} ms, solo {out['solo_step_ms'] or 0:.1f} ms "
          f"(group 0's rank 0, host clock); both groups end at step {out['final_step']} with "
          f"params_sha256 {out['params_sha256'][:16]}...; launches {out['launches']} ({card})",
          flush=True)
    return out


def combine_cost(card: str, repeats: int = 10) -> dict:
    """The MoE combine's product at (a)'s shapes a rank, [T, X/2 * C] @
    [X/2 * C, E] in bf16: ms a call (CUDA events, ``repeats`` calls) of the
    f32-output product that ``moe_ffn`` runs, of the plain bf16 product,
    and of the f32 product of the operands cast up."""
    import torch

    from torchft_tpu_torch.models import moe_capacity
    from torchft_tpu_torch.models.moe import _F32Product

    cfg, batch, seq = moe_config()
    T = batch * seq
    xc = cfg.moe_experts // 2 * moe_capacity(T, cfg.moe_experts, cfg.moe_top_k,
                                            cfg.moe_capacity_factor)
    gen = torch.Generator(device="cuda").manual_seed(23)
    a = torch.randn(T, xc, device="cuda", generator=gen).to(torch.bfloat16)
    b = torch.randn(xc, cfg.d_model, device="cuda", generator=gen).to(torch.bfloat16)
    out = {"shape": [T, xc, cfg.d_model]}
    for name, fn in (("f32_out", lambda: _F32Product.apply(a, b)), ("bf16", lambda: a @ b),
                     ("cast_up", lambda: a.float() @ b.float())):
        fn()
        torch.cuda.synchronize()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
        for _ in range(repeats):
            fn()
        events[1].record()
        events[1].synchronize()
        out[name] = events[0].elapsed_time(events[1]) / repeats
    print(f"  (a) the combine's product a rank, {out['shape']}: f32-output (moe_ffn's) "
          f"{out['f32_out']:.4f} ms, bf16 {out['bf16']:.4f} ms, f32 of operands cast up "
          f"{out['cast_up']:.4f} ms ({card})", flush=True)
    return out


def p17_phase(card: str, ranks: dict, kill: dict) -> dict:
    """Phase 17: (a) and (b) from ``ranks`` (:func:`p17_start`'s, started
    earlier beside another phase), and ``kill``: (c)'s result
    (:func:`p17_kill`, run earlier beside another phase).  Each counts its
    own processes' launches."""
    t0 = time.monotonic()
    out = p17_finish(ranks, card)
    out["moe"]["combine_ms"] = combine_cost(card)
    out["kill"] = kill
    out["phase_s"] = time.monotonic() - t0
    launches = collections.Counter()
    for leg in ("moe", "pipe", "kill"):
        launches.update(out[leg]["launches"])
    out["launches"] = dict(launches)
    out["card"] = card
    print("MOE_PIPELINE " + json.dumps(out), flush=True)
    print(f"  MoE and pipeline phase: {out['phase_s']:.1f} s here ({card})", flush=True)
    return out


# Phase 18: long context on the flagship (12 layers, d_model 768, 6 x 128
# heads, vocab 32000, seq 1024) over {sequence 2}: each rank holds 512
# positions of every sequence.  (a) ring contiguous, ring zigzag and Ulysses
# against the flagship unsharded (flash) in rank 0, on the same weights
# and batch (zigzag's tokens and targets permuted on the host).
P18_BACKENDS = (("ring", "ring", "contiguous"), ("zigzag", "ring", "zigzag"),
                ("ulysses", "ulysses", "contiguous"))
P18_BATCH = 16
P18_PASSES = 2            # bf16 passes a backend, each held (the first a warm-up for its times)
P18_F32_BATCH = 2         # the f32 pass's batch (the plain path materializes the scores)
P18_RANK_TIMEOUT_S = 420.0
# (b): train_ring --model flagship --layout zigzag, 2 groups x {sequence 2}
# on the card; group 0's merged commits before group 1's SIGKILL, and the
# steps both end merged past (the cap: phase 17 (c)'s).
P18_KILL_AFTER = 3
P18_KILL_STEPS = 8
P18_KILL_CAP = 160
P18_KILL_TIMEOUT_S = 360.0
# Sharded against unsharded.  bf16 (the kernels): the ring's block products
# round p to bf16 per block and merge in f32, the flash kernel per tile, so
# the two agree to bf16 rounding: the loss within TOL_P18_LOSS of its value
# and each gradient within TOL_P18_GRAD of its tensor's max.  f32 (the plain
# path): the same sums reassociated, within TOL_P18_F32_*.  Each limit is at
# most 10x the worst reading over the recorded runs on an H100 80GB HBM3 at
# 700 W (PERF.md section 6, long context): bf16 loss 4.73e-6, gradient 3.62e-2;
# f32 gradient 6.95e-6, and the f32 loss equal bit for bit in every run, so
# held equal.  A planted fault in each backend (a dropped block, the zigzag
# positions left contiguous, the exchange on the wrong dims) moved the f32
# loss by 1.2e-4 to 1.6e-3 and a gradient by 1.7 of its max or more, and
# must fail the f32 check.
TOL_P18_LOSS = 4e-5
TOL_P18_GRAD = 5e-2
TOL_P18_F32_LOSS = 0.0
TOL_P18_F32_GRAD = 5e-5


def p18_config(backend: str, dtype):
    """The flagship under one of P18_BACKENDS (``name`` "flash": unsharded)."""
    import dataclasses

    from torchft_tpu_torch.models import flagship_config

    cfg = dataclasses.replace(flagship_config()[0], dtype=dtype)
    for name, attention, layout in P18_BACKENDS:
        if name == backend:
            return dataclasses.replace(cfg, attention=attention, ring_layout=layout)
    return cfg


def _p18_shard(b: dict, cfg, ftmesh) -> dict:
    """This rank's slice of each sequence of the group's batch (zigzag
    order first under ring_layout "zigzag")."""
    from torchft_tpu_torch.data import shard_sequence
    from torchft_tpu_torch.ops.ring_attention import to_zigzag

    n = ftmesh.size("sequence")
    if cfg.attention == "ring" and cfg.ring_layout == "zigzag":
        b = {k: to_zigzag(v, n, dim=1) for k, v in b.items()}
    return {k: shard_sequence(v, ftmesh.coordinate("sequence"), n) for k, v in b.items()}


def _wire_bytes(counter: dict):
    """Counts the bytes each ring hop and each exchange hands to gloo in
    this process (``counter["hop"]``, ``counter["exchange"]``) while on;
    returns the restore function."""
    import torchft_tpu_torch.ops.ring_attention as ra
    from torchft_tpu_torch.parallel import functional

    hop, exchange = ra.ring_shift, functional.exchange

    def counted_hop(x, group, shift=1):
        counter["hop"] += x.numel() * x.element_size()
        return hop(x, group, shift)

    def counted_exchange(x, split_dim, concat_dim, group):
        counter["exchange"] += x.numel() * x.element_size()
        return exchange(x, split_dim, concat_dim, group)

    ra.ring_shift, functional.exchange = counted_hop, counted_exchange

    def restore():
        ra.ring_shift, functional.exchange = hop, exchange
    return restore


def _p18_pass(model, b: dict, ftmesh) -> dict:
    """One forward and backward of the sharded ``model`` on this rank's
    slice of ``b``: loss, gradients, forward and backward ms (CUDA events),
    the launches, the peak and the bytes hopped and exchanged."""
    import torch
    import torch.distributed as dist

    from torchft_tpu_torch.ops import launch_counts, reset_launch_counts

    mine = _p18_shard(b, model.cfg, ftmesh)
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    counter = {"hop": 0, "exchange": 0}
    restore = _wire_bytes(counter)
    try:
        reset_launch_counts()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        events[0].record()
        loss = model.loss(mine)
        events[1].record()
        loss.backward()
        events[2].record()
        events[2].synchronize()
    finally:
        restore()
    return {"loss": loss.item(), "fwd_ms": events[0].elapsed_time(events[1]),
            "bwd_ms": events[1].elapsed_time(events[2]), "launches": launch_counts(),
            "peak_bytes": torch.cuda.max_memory_allocated(), "bytes": dict(counter),
            "grads": {n: ftmesh.full_tensor(p.grad) for n, p in model.named_parameters()}}


def _p18_errs(rec: dict, ref: dict) -> dict:
    errs = _grad_errs(rec.pop("grads"), ref["grads"])
    worst = max(errs, key=errs.get)
    rec.update(loss_err=abs(rec["loss"] - ref["loss"]) / abs(ref["loss"]), grad_err=errs[worst],
               worst_grad=worst)
    return rec


def sharded_check(what: str, rec: dict, tol_loss: float, tol_grad: float) -> None:
    """Raises unless ``rec``'s loss is finite and within ``tol_loss`` of the
    unsharded one and its worst gradient within ``tol_grad`` of its max."""
    if not math.isfinite(rec["loss"]) or rec["loss_err"] > tol_loss:
        raise AssertionError(f"{what}: loss {rec['loss']} against the unsharded: "
                             f"{rec['loss_err']:.3e} > {tol_loss}")
    if rec["grad_err"] > tol_grad:
        raise AssertionError(f"{what}: gradient {rec['worst_grad']} differs from the unsharded "
                             f"by {rec['grad_err']:.3e} of its max > {tol_grad}")


def _p18_faults() -> dict:
    """Each backend's planted fault, as (patch, restore): the ring drops
    each off-diagonal block (on rank 1 of 2, the block of rank 0's keys),
    the zigzag ropes with contiguous positions, the exchange swaps the head
    dim with itself instead of the sequence dim."""
    import dataclasses

    import torchft_tpu_torch.models.transformer as tr
    import torchft_tpu_torch.ops.ring_attention as ra
    import torchft_tpu_torch.ops.ulysses as ul

    block, positions, exchange = ra._block_attn, tr._positions, ul.all_to_all

    def dropped(q, k, v, scale, row0, col0, causal):
        if row0 != col0:
            return ra._neutral(q)
        return block(q, k, v, scale, row0, col0, causal)

    def contiguous(cfg, ftmesh, s_local, device):
        return positions(dataclasses.replace(cfg, ring_layout="contiguous"), ftmesh, s_local,
                         device)

    def wrong_dims(x, split_dim, concat_dim, group):
        return exchange(x, 1, 1, group)

    def setter(mod, name, fn, real):
        return (lambda: setattr(mod, name, fn)), (lambda: setattr(mod, name, real))

    return {"ring": setter(ra, "_block_attn", dropped, block),
            "zigzag": setter(tr, "_positions", contiguous, positions),
            "ulysses": setter(ul, "all_to_all", wrong_dims, exchange)}


def ring_leg(rank: int, dev) -> dict:
    """Phase 18 (a) in this rank: each backend of P18_BACKENDS over {sequence
    2} against the flagship unsharded, which rank 0 computes on the same
    weights and batches: in f32 (the plain path, batch P18_F32_BATCH, then
    each backend's planted fault) and in bf16 (the kernels, batch
    P18_BATCH, P18_PASSES passes)."""
    import torch
    import torch.distributed as dist

    from torchft_tpu_torch.models import Transformer, parallelize
    from torchft_tpu_torch.parallel import ft_init_mesh

    seq = p18_config("flash", torch.float32).max_seq
    ftmesh = ft_init_mesh({"sequence": dist.get_world_size()}, device_type="cuda")
    faults = _p18_faults()
    out = {}

    def build(cfg):
        return Transformer(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(18))

    for dtype, batch, passes in ((torch.float32, P18_F32_BATCH, 1),
                                 (torch.bfloat16, P18_BATCH, P18_PASSES)):
        key = "f32" if dtype == torch.float32 else "bf16"
        batches = [_hsdp_batch(p18_config("flash", dtype), batch, seq, 1800 + s, dev)
                   for s in range(passes)]
        refs = []
        if rank == 0:
            ref = build(p18_config("flash", dtype))
            for b in batches:
                ref.zero_grad(set_to_none=True)
                loss = ref.loss(b)
                loss.backward()
                refs.append({"loss": loss.item(),
                             "grads": {n: p.grad for n, p in ref.named_parameters()}})
            del ref
        for name, _, _ in P18_BACKENDS:
            model = parallelize(build(p18_config(name, dtype)), ftmesh)
            recs = []
            for s, b in enumerate(batches):
                rec = _p18_pass(model, b, ftmesh)
                recs.append(_p18_errs(rec, refs[s]) if refs else
                            {k: v for k, v in rec.items() if k != "grads"})
            if dtype == torch.float32:
                patch, restore = faults[name]
                patch()
                try:
                    rec = _p18_pass(model, batches[0], ftmesh)
                finally:
                    restore()
                fault = _p18_errs(rec, refs[0]) if refs else None
                out.setdefault("faults", {})[name] = fault and {
                    k: fault[k] for k in ("loss", "loss_err", "grad_err", "worst_grad")}
            out.setdefault(key, {})[name] = recs
            del model
            torch.cuda.empty_cache()
        out[key]["ref_losses"] = [r["loss"] for r in refs]
        out[key]["batch"] = batch
        del refs
        torch.cuda.empty_cache()
    return out


def run_p18_rank(args: argparse.Namespace) -> None:
    """One local rank of phase 18 (a): the group's world over gloo through
    the slice bootstrap (the ranks share the card), then :func:`ring_leg`;
    the result goes to the run directory."""
    import torch
    import torch.distributed as dist

    from torchft_tpu_torch.multihost import initialize_slice

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    initialize_slice(backend="gloo")
    out = ring_leg(args.p18_rank, dev)
    with open(os.path.join(args.run_dir, f"rank{args.p18_rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def p18_ranks(card: str) -> dict:
    """Phase 18 (a): two local ranks on the card, spawned as ``chip_smoke.py
    --p18-rank r``, rendezvous through a Store; returns their records and
    their wall time."""
    from torchft_tpu_torch.coordination import StoreServer

    run_dir = tempfile.mkdtemp(prefix="tpuft_p18_")
    store = StoreServer(bind="127.0.0.1:0")
    procs = []
    t0 = time.monotonic()
    try:
        env = dict(os.environ, TPUFT_NUM_HOSTS="2", TPUFT_STORE=store.address(),
                   TPUFT_COORD_PORT=str(free_port()), MASTER_ADDR="127.0.0.1")
        for r in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--p18-rank", str(r),
                 "--run-dir", run_dir], env=dict(env, TPUFT_HOST_RANK=str(r)), cwd=HERE))
        deadline = t0 + P18_RANK_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                raise TimeoutError(f"phase 18: the ranks ran past {P18_RANK_TIMEOUT_S} s")
            if any(p.poll() not in (None, 0) for p in procs):
                raise AssertionError(f"phase 18: a rank failed: {[p.poll() for p in procs]}")
            time.sleep(0.1)
        if any(p.returncode != 0 for p in procs):
            raise AssertionError(f"phase 18: a rank failed: {[p.returncode for p in procs]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(run_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        store.shutdown()
        shutil.rmtree(run_dir, ignore_errors=True)
    return {"ranks": ranks, "wall_s": time.monotonic() - t0}


def p18_checks(card: str, ranks: list) -> dict:
    """Prints (a)'s numbers a backend, then holds them: K1-K5 12 / 12 / 12 /
    1 / 1 a rank a bf16 pass under Ulysses and 0 / 0 / 0 / 1 / 1 under the
    ring, none in f32; the ranks' losses equal; the f32 and bf16 losses
    and gradients against the unsharded (TOL_P18_*); each planted fault
    failing its backend's f32 check."""
    from torchft_tpu_torch.models import flagship_config

    L = flagship_config()[0].n_layers
    head = ranks[0]
    out = {"launches": {}}
    for name, _, _ in P18_BACKENDS:
        flash = L if name == "ulysses" else 0
        want = {"flash_fwd": flash, "flash_bwd_dkdv": flash, "flash_bwd_dq": flash, "ce_lse": 1,
                "ce_dlogits": 1}
        launches = collections.Counter()
        for r, rank in enumerate(ranks):
            for s, rec in enumerate(rank["bf16"][name]):
                launches.update(rec["launches"])
                if _kernel_counts(rec["launches"]) != want:
                    raise AssertionError(f"phase 18 (a) {name} rank {r} pass {s} launched "
                                         f"{_kernel_counts(rec['launches'])}, expected {want}")
            if any(rank["f32"][name][0]["launches"].get(k, 0) for k in want):
                raise AssertionError(f"phase 18 (a) {name} rank {r}: the f32 pass launched "
                                     f"{rank['f32'][name][0]['launches']}, expected the plain path")
            for key in ("f32", "bf16"):
                if [x["loss"] for x in rank[key][name]] != [x["loss"] for x in head[key][name]]:
                    raise AssertionError(f"phase 18 (a) {name} {key}: the ranks' losses differ")
        f32, bf16 = head["f32"][name][0], head["bf16"][name]
        fault = head["faults"][name]
        o = out[name] = {
            "f32": {k: f32[k] for k in ("loss", "loss_err", "grad_err", "worst_grad")},
            "bf16": {k: [x[k] for x in bf16] for k in ("loss", "loss_err", "grad_err",
                                                          "worst_grad")},
            "fwd_ms": [[x["fwd_ms"] for x in rank["bf16"][name]] for rank in ranks],
            "bwd_ms": [[x["bwd_ms"] for x in rank["bf16"][name]] for rank in ranks],
            "peak_bytes": [max(x["peak_bytes"] for x in rank["bf16"][name]) for rank in ranks],
            "bytes": [rank["bf16"][name][-1]["bytes"] for rank in ranks],
            "fault": fault, "launches": dict(launches)}
        out["launches"][name] = dict(launches)
        print(f"  (a) {name} over sequence 2: f32 (plain path, batch {head['f32']['batch']}) loss "
              f"{f32['loss']:.7f} against unsharded {head['f32']['ref_losses'][0]:.7f} "
              f"({f32['loss_err']:.2e} of it, allowed {TOL_P18_F32_LOSS}), gradients within "
              f"{f32['grad_err']:.2e} of each max (allowed {TOL_P18_F32_GRAD}; the worst "
              f"{f32['worst_grad']}); planted fault: loss {fault['loss_err']:.2e}, gradient "
              f"{fault['grad_err']:.2e}; bf16 (the kernels, batch {head['bf16']['batch']}) losses "
              f"{', '.join(f'{x:.6f}' for x in o['bf16']['loss'])} against unsharded "
              f"{', '.join(f'{x:.6f}' for x in head['bf16']['ref_losses'])} (worst "
              f"{max(o['bf16']['loss_err']):.2e}, allowed {TOL_P18_LOSS}), gradients within "
              f"{max(o['bf16']['grad_err']):.2e} of each max (allowed {TOL_P18_GRAD}; the worst "
              f"{o['bf16']['worst_grad']}); forward ms a rank "
              f"{[[round(x, 2) for x in ms] for ms in o['fwd_ms']]}, backward "
              f"{[[round(x, 2) for x in ms] for ms in o['bwd_ms']]} (CUDA events, the ranks sharing "
              f"the card, the first a warm-up); peak "
              f"{[round(p / 2**30, 3) for p in o['peak_bytes']]} GiB a rank (rank 0 also held the "
              f"unsharded model's gradients); bytes a rank a step {o['bytes']}; launches a rank a "
              f"pass {_kernel_counts(bf16[-1]['launches'])} ({card})", flush=True)
        sharded_check(f"phase 18 (a) {name} f32", f32, TOL_P18_F32_LOSS, TOL_P18_F32_GRAD)
        for s in range(P18_PASSES):
            sharded_check(f"phase 18 (a) {name} bf16 pass {s}", bf16[s], TOL_P18_LOSS,
                          TOL_P18_GRAD)
        try:
            sharded_check(f"phase 18 (a) {name} planted fault", dict(fault), TOL_P18_F32_LOSS,
                          TOL_P18_F32_GRAD)
        except AssertionError:
            pass
        else:
            raise AssertionError(f"phase 18 (a) {name}: the planted fault passed the f32 check "
                                 f"(loss {fault['loss_err']:.3e}, gradient "
                                 f"{fault['grad_err']:.3e})")
    return out


def p18_kill(card: str) -> dict:
    """Phase 18 (b): train_ring --model flagship --layout zigzag under the
    launcher, two groups of {sequence 2} (gloo on the shared card), group 1
    SIGKILLed after P18_KILL_AFTER merged commits: its ranks die with it,
    each restarted rank heals its own state over HTTP from group 0's same
    rank, and both groups end with one params_sha256.  The ring runs no
    flash kernel: K4 and K5 must launch."""
    out = ranked_kill("phase 18 (b)", "train_ring",
                      ["--model", "flagship", "--devices", "2", "--sequence", "2", "--layout",
                       "zigzag", "--batch", str(P18_BATCH)],
                      P18_KILL_STEPS, P18_KILL_CAP, P18_KILL_AFTER, P18_KILL_TIMEOUT_S,
                      kernels=("ce_lse", "ce_dlogits"))
    print(f"  (b) train_ring zigzag, 2 groups x sequence 2, group 1 SIGKILLed: its ranks "
          f"{out['killed_rank_pids']} gone; each rank healed its state (heal span ms "
          f"{out['heal_ms']}; fetched { {k: (v['bytes'], v['fetch_s']) for k, v in out['healed'].items()} } "
          f"bytes, s); kill -> first merged commit {out['recovery_s']:.3f} s; merged step "
          f"{out['merged_step_ms']:.1f} ms, solo {out['solo_step_ms'] or 0:.1f} ms (group 0's "
          f"rank 0, host clock); both groups end at step {out['final_step']} with params_sha256 "
          f"{out['params_sha256'][:16]}...; launches {out['launches']} ({card})", flush=True)
    return out


def p18_legs(card: str) -> dict:
    """Phase 18's legs, run from a side thread beside other phases: (b),
    then (a)'s ranks."""
    return {"kill": p18_kill(card), "a": p18_ranks(card)}


def p18_phase(card: str, legs: dict) -> dict:
    """Phase 18: holds (a)'s records and reads (b)'s result, both from
    ``legs`` (:func:`p18_legs`, run earlier beside other phases)."""
    t0 = time.monotonic()
    out = p18_checks(card, legs["a"]["ranks"])
    out["kill"] = legs["kill"]
    out["ranks_s"] = legs["a"]["wall_s"]
    print(f"  (a): {out['ranks_s']:.1f} s from the ranks' start to their results ({card})",
          flush=True)
    launches = {"ring": collections.Counter(), "ulysses": collections.Counter()}
    for name, _, _ in P18_BACKENDS:
        launches["ulysses" if name == "ulysses" else "ring"].update(out["launches"][name])
    out["launches"] = {k: dict(v) for k, v in launches.items()}
    out["phase_s"] = time.monotonic() - t0
    out["card"] = card
    print("LONG_CONTEXT " + json.dumps(out), flush=True)
    print(f"  long-context phase: {out['phase_s']:.1f} s here ({card})", flush=True)
    return out


# Phase 19: the MoE flagship (moe_config: 12 layers, d_model 768, 6 x 128
# heads, seq 1024, 8 experts, top 2, capacity 1.25, batch MOE_BATCH) over
# {tensor 2} (each rank F / 2 of every expert, all 8 experts' dispatch) and
# over {sequence 2} under Ulysses and under the zigzag ring (each rank 512
# positions of every sequence, routed in the group's order).  Run in phase
# 17's two rank processes after their (a) and (b), against the same model
# unsharded (flash) in rank 0, on the same weights and batches; the
# tolerances are phase 17 (a)'s (TOL_P17_*).  The f32 passes run at
# P19_F32_FACTOR, where tokens drop, so that slots offset wrongly show.
P19_LEGS = (("tensor", {"tensor": 2}, "flash", "contiguous"),
            ("ulysses", {"sequence": 2}, "ulysses", "contiguous"),
            ("zigzag", {"sequence": 2}, "ring", "zigzag"))
P19_F32_FACTOR = 0.5
# Each leg's planted fault (which must fail its f32 check): over "tensor"
# the dispatched input enters the F-slice without copy_to (its gradient
# keeps one rank's partial sum); over "sequence" the slot offsets are taken
# without the other "sequence" ranks' counts.
P19_FAULTS = {"tensor": "copy_to", "ulysses": "offsets", "zigzag": "offsets"}


def _p19_fault(kind: str):
    """(patch, restore) of one of P19_FAULTS in ``models/moe.py``."""
    import torch

    import torchft_tpu_torch.models.moe as moe

    if kind == "copy_to":
        real, name = moe.copy_to, "copy_to"

        def fault(x, group):
            return x
    else:
        real, name = moe._rows_over_sequence, "_rows_over_sequence"

        def fault(counts, ftmesh):
            rows = torch.zeros((ftmesh.size("sequence"),) + tuple(counts.shape),
                               dtype=counts.dtype, device=counts.device)
            rows[ftmesh.coordinate("sequence")] = counts
            return rows
    return (lambda: setattr(moe, name, fault)), (lambda: setattr(moe, name, real))


def _zigzag_routing(n: int):
    """Makes the unsharded model route as a zigzag-sharded one does: its
    ``moe_ffn`` is handed each sequence in the zigzag order over ``n``
    ranks (the order the sharded run's tokens arrive in) and its output put
    back.  Returns the restore function."""
    import torch

    import torchft_tpu_torch.models.transformer as tr
    from torchft_tpu_torch.ops.ring_attention import zigzag_permutation

    inner = tr.moe_ffn

    def permuted(x, *args, **kw):
        perm = torch.from_numpy(zigzag_permutation(x.shape[1], n)).to(x.device)
        y, aux = inner(x.index_select(1, perm), *args, **kw)
        return y.index_select(1, torch.argsort(perm)), aux

    tr.moe_ffn = permuted
    return lambda: setattr(tr, "moe_ffn", inner)


def _group_routing(records: list, ftmesh, rows: int) -> list:
    """Each layer's (gate_idx, kept) over the group's tokens, [B * S, k], in
    the order they arrive: this rank's [rows * S_local, k] gathered over
    "sequence" along each row (every rank calls it)."""
    import torch

    from torchft_tpu_torch.parallel.functional import all_gather_cat

    out = []
    for rec in records:
        gate, kept = rec[0]["gate_idx"], rec[0]["kept"].to(torch.uint8)
        if ftmesh.size("sequence") > 1:
            group = ftmesh.group("sequence")
            gate, kept = (all_gather_cat(t.reshape(rows, -1, t.shape[-1]), 1, group).flatten(0, 1)
                          for t in (gate, kept))
        out.append((gate, kept.bool()))
    return out


def _p19_passes(cfg, ftmesh, batch: int, seq: int, passes: int, seed: int, rank: int, dev,
                fault: str = None) -> tuple:
    """``passes`` forward and backward passes of the MoE model over the
    leg's mesh and, in rank 0, of the same model unsharded on the whole
    batch, replaying the sharded run's routing (the zigzag order under
    that layout); then, with ``fault``, one more sharded pass on the first
    batch with the fault planted, held against the same reference.
    Returns (the sharded model, the records)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from torchft_tpu_torch.models import Transformer, moe_capacity, parallelize

    def build(c):
        return Transformer(c, device=dev, generator=torch.Generator(device=dev).manual_seed(19))

    model = parallelize(build(cfg), ftmesh)
    ref = build(dataclasses.replace(cfg, attention="flash", ring_layout="contiguous")) \
        if rank == 0 else None
    n = ftmesh.size("sequence")
    zigzag = cfg.attention == "ring" and cfg.ring_layout == "zigzag"
    t_local = batch * seq // n
    C = moe_capacity(batch * seq, cfg.moe_experts, cfg.moe_top_k, cfg.moe_capacity_factor)
    out = {"batch": batch, "passes": [], "tokens": batch * seq, "t_local": t_local,
           "capacity": C, "dispatch_bytes": t_local * cfg.moe_experts * C * 4}

    def recording(m):
        records = [[] for _ in m.layers]
        for layer, r in zip(m.layers, records):
            layer.moe_record = r
        return records

    def sharded(b):
        records = recording(model)
        rec = _p18_pass(model, b, ftmesh)
        routing = _group_routing(records, ftmesh, batch)
        rec["dropped"] = sum(int((~kept).sum()) for _, kept in routing)
        rec["choices"] = sum(kept.numel() for _, kept in routing)
        return rec, routing

    first_ref = None
    for s in range(passes):
        b = _hsdp_batch(cfg, batch, seq, seed + s, dev)
        rec, routing = sharded(b)
        if ref is not None:
            ref_records = recording(ref)
            for layer, (gate, _) in zip(ref.layers, routing):
                layer.moe_route = gate
            restore = _zigzag_routing(n) if zigzag else (lambda: None)
            try:
                ref_loss = ref.loss(b)
                ref_loss.backward()
            finally:
                restore()
            want = {"loss": ref_loss.item(),
                    "grads": {k: p.grad for k, p in ref.named_parameters()}}
            rec = _p18_errs(rec, want)
            rec["ref_loss"] = want["loss"]
            rec["rerouted"] = [int((r[0]["own_idx"] != r[0]["gate_idx"]).any(-1).sum())
                               for r in ref_records]
            ref.zero_grad(set_to_none=True)
            if first_ref is None and fault is not None:
                first_ref = want  # the fault's reference
            del want
        else:
            rec.pop("grads")
        out["passes"].append(rec)
        del routing
    if fault is not None:
        patch, restore = _p19_fault(fault)
        patch()
        try:
            rec, _ = sharded(_hsdp_batch(cfg, batch, seq, seed, dev))
        finally:
            restore()
        out["fault"] = ({k: v for k, v in _p18_errs(rec, first_ref).items()
                         if k in ("loss", "loss_err", "grad_err", "worst_grad", "dropped")}
                        if ref is not None else None)
    for m in (model, ref):
        for layer in m.layers if m is not None else ():
            layer.moe_record = layer.moe_route = None
    del ref, first_ref
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    dist.barrier()
    return model, out


def moe_mesh_leg(name: str, sizes: dict, attention: str, layout: str, rank: int, dev,
                 manager) -> dict:
    """One leg of phase 19 in this rank: the MoE model over ``sizes``
    against it unsharded, in f32 (the plain path, batch MOE_F32_BATCH, at
    P19_F32_FACTOR, then the leg's planted fault) and in bf16 (the kernels,
    batch MOE_BATCH, MOE_STEPS passes); then MOE_FT_STEPS ft_steps of the
    bf16 model under the rank's Manager, on the rank's share of each
    batch."""
    import dataclasses

    import torch

    from torchft_tpu_torch.models import loss_fn
    from torchft_tpu_torch.parallel import TrainStep, ft_init_mesh

    t0 = time.monotonic()
    cfg, batch, seq = moe_config()
    cfg = dataclasses.replace(cfg, attention=attention, ring_layout=layout)
    ftmesh = ft_init_mesh(sizes, device_type="cuda")
    f32cfg = dataclasses.replace(cfg, dtype=torch.float32, moe_capacity_factor=P19_F32_FACTOR)
    model, f32 = _p19_passes(f32cfg, ftmesh, MOE_F32_BATCH, seq, 1, 190, rank, dev,
                             fault=P19_FAULTS[name])
    del model
    torch.cuda.empty_cache()
    model, out = _p19_passes(cfg, ftmesh, batch, seq, MOE_STEPS, 192, rank, dev)
    out["f32"] = f32
    opt = torch.optim.SGD(model.parameters(), lr=P17_LR)
    trainer = TrainStep(model, opt, loss_fn, manager, overlap_commit=False)
    out["ft"] = []
    for s in range(MOE_FT_STEPS):
        b = _p18_shard(_hsdp_batch(cfg, batch, seq, 197 + s, dev), cfg, ftmesh)
        manager.start_quorum()
        (loss, committed), ms, counts, _ = _timed(lambda: trainer.ft_step(b))
        out["ft"].append({"loss": loss.item(), "committed": committed, "ms": ms,
                          "launches": counts})
    del model, opt, trainer
    torch.cuda.empty_cache()
    out["wall_s"] = time.monotonic() - t0
    return out


def p19_legs(rank: int, dev, manager) -> dict:
    """Phase 19's legs in this rank, in P19_LEGS' order."""
    return {name: moe_mesh_leg(name, sizes, attention, layout, rank, dev, manager)
            for name, sizes, attention, layout in P19_LEGS}


def p19_check(what: str, rec: dict, tol_loss: float, tol_grad: float, reroute: float,
              tokens: int) -> None:
    """:func:`sharded_check`, and no layer's tokens routed otherwise beyond
    ``reroute`` of ``tokens``."""
    sharded_check(f"phase 19 {what}", rec, tol_loss, tol_grad)
    if max(rec["rerouted"]) > reroute * tokens:
        raise AssertionError(f"phase 19 {what}: tokens routed otherwise a layer "
                             f"{rec['rerouted']} of {tokens} > {reroute}")


def p19_phase(card: str, ranks: list) -> dict:
    """Phase 19: prints each leg's numbers from ``ranks`` (the phase 17
    rank processes' records, run beside phase 6), then holds them: K1-K5
    a rank a bf16 pass and ft_step 12 / 12 / 12 / 0 / 0 over "tensor", 12 /
    12 / 12 / 1 / 1 under Ulysses, 0 / 0 / 0 / 1 / 1 under the ring, none in
    f32; the ranks' losses equal; the f32 loss and gradients against the
    unsharded (TOL_P17_F32_*, no token routed otherwise), the bf16 ones on
    the replayed routing (TOL_P17_*, TOL_P17_REROUTE); each planted fault
    failing the f32 check; committed ft_steps with finite losses."""
    t0 = time.monotonic()
    L = moe_config()[0].n_layers
    head = ranks[0]
    out = {"launches": {}, "card": card}
    for name, sizes, attention, _ in P19_LEGS:
        flash = 0 if attention == "ring" else L
        ce = 0 if "tensor" in sizes else 1
        want = {"flash_fwd": flash, "flash_bwd_dkdv": flash, "flash_bwd_dq": flash,
                "ce_lse": ce, "ce_dlogits": ce}
        launches = collections.Counter()
        for r, rank in enumerate(ranks):
            leg = rank[name]
            counts = [p["launches"] for p in leg["passes"]] + [f["launches"] for f in leg["ft"]]
            for s, c in enumerate(counts):
                launches.update(c)
                if _kernel_counts(c) != want:
                    raise AssertionError(f"phase 19 {name} rank {r} step {s} launched "
                                         f"{_kernel_counts(c)}, expected {want}")
            if any(leg["f32"]["passes"][0]["launches"].get(k, 0) for k in want):
                raise AssertionError(f"phase 19 {name} rank {r}: the f32 pass launched "
                                     f"{leg['f32']['passes'][0]['launches']}, expected the plain "
                                     f"path")
            if [p["loss"] for p in leg["passes"]] != [p["loss"] for p in head[name]["passes"]] or \
                    leg["f32"]["passes"][0]["loss"] != head[name]["f32"]["passes"][0]["loss"]:
                raise AssertionError(f"phase 19 {name}: the ranks' losses differ")
            for s, f in enumerate(leg["ft"]):
                if not f["committed"] or not math.isfinite(f["loss"]):
                    raise AssertionError(f"phase 19 {name} rank {r} ft_step {s}: committed "
                                         f"{f['committed']}, loss {f['loss']}")
        leg = head[name]
        f32, bf16, fault = leg["f32"]["passes"][0], leg["passes"], leg["f32"]["fault"]
        o = out[name] = {
            "f32": {k: f32[k] for k in ("loss", "ref_loss", "loss_err", "grad_err", "worst_grad",
                                        "rerouted", "dropped", "choices")},
            "bf16": {k: [p[k] for p in bf16] for k in ("loss", "ref_loss", "loss_err",
                                                         "grad_err", "worst_grad", "rerouted",
                                                         "dropped", "choices")},
            "fault": fault,
            "fwd_ms": [[p["fwd_ms"] for p in rank[name]["passes"]] for rank in ranks],
            "bwd_ms": [[p["bwd_ms"] for p in rank[name]["passes"]] for rank in ranks],
            "peak_bytes": [max(p["peak_bytes"] for p in rank[name]["passes"]) for rank in ranks],
            "dispatch_bytes": leg["dispatch_bytes"], "t_local": leg["t_local"],
            "capacity": leg["capacity"], "tokens": leg["tokens"],
            "ft_ms": [[f["ms"] for f in rank[name]["ft"]] for rank in ranks],
            "ft_losses": [f["loss"] for f in leg["ft"]],
            "wall_s": [rank[name]["wall_s"] for rank in ranks], "launches": dict(launches)}
        out["launches"][name] = dict(launches)
        print(f"  ({'abc'[[n for n, *_ in P19_LEGS].index(name)]}) MoE over "
              f"{'x'.join(f'{a} {v}' for a, v in sizes.items())} ({name}): f32 (plain path, batch "
              f"{leg['f32']['batch']}, capacity factor {P19_F32_FACTOR}) loss {f32['loss']:.7f} "
              f"against unsharded {f32['ref_loss']:.7f} ({f32['loss_err']:.2e} of it, allowed "
              f"{TOL_P17_F32_LOSS}), gradients within {f32['grad_err']:.2e} of each max (allowed "
              f"{TOL_P17_F32_GRAD}; the worst {f32['worst_grad']}), tokens routed otherwise a "
              f"layer {f32['rerouted']}, choices dropped {f32['dropped']} of {f32['choices']}; "
              f"planted fault ({P19_FAULTS[name]}): loss {fault['loss_err']:.2e}, gradient "
              f"{fault['grad_err']:.2e} ({fault['worst_grad']}), dropped {fault['dropped']}; bf16 "
              f"(the kernels, batch {leg['batch']}) losses "
              f"{', '.join(f'{x:.6f}' for x in o['bf16']['loss'])} against unsharded "
              f"{', '.join(f'{x:.6f}' for x in o['bf16']['ref_loss'])} (worst "
              f"{max(o['bf16']['loss_err']):.2e}, allowed {TOL_P17_LOSS}), gradients within "
              f"{max(o['bf16']['grad_err']):.2e} of each max (allowed {TOL_P17_GRAD}; the worst "
              f"{o['bf16']['worst_grad']}), the unsharded model on the sharded routing; tokens "
              f"its own router sends elsewhere, a layer, {o['bf16']['rerouted']} of "
              f"{leg['tokens']} (allowed {int(TOL_P17_REROUTE * leg['tokens'])}); choices dropped "
              f"{o['bf16']['dropped']} of {o['bf16']['choices'][0]}; forward ms a rank "
              f"{[[round(x, 2) for x in ms] for ms in o['fwd_ms']]}, backward "
              f"{[[round(x, 2) for x in ms] for ms in o['bwd_ms']]} (CUDA events, the ranks "
              f"sharing the card, the first a warm-up); peak "
              f"{[round(p / 2**30, 3) for p in o['peak_bytes']]} GiB a rank (rank 0 also holds "
              f"the unsharded model); dispatch [T {leg['t_local']}, {MOE_EXPERTS}, C "
              f"{leg['capacity']}] f32 {leg['dispatch_bytes'] / 1e9:.3f} GB a layer a rank (and "
              f"the combine as much); {MOE_FT_STEPS} committed ft_steps, losses "
              f"{o['ft_losses']}, ms a rank {[[round(x, 1) for x in ms] for ms in o['ft_ms']]}; "
              f"launches a rank a pass {_kernel_counts(bf16[-1]['launches'])}; the leg "
              f"{[round(x, 1) for x in o['wall_s']]} s a rank ({card})", flush=True)
        p19_check(f"{name} f32", f32, TOL_P17_F32_LOSS, TOL_P17_F32_GRAD, 0.0, leg["tokens"])
        for s, p in enumerate(bf16):
            p19_check(f"{name} bf16 pass {s}", p, TOL_P17_LOSS, TOL_P17_GRAD, TOL_P17_REROUTE,
                      leg["tokens"])
        try:
            sharded_check(f"phase 19 {name} planted fault", fault, TOL_P17_F32_LOSS,
                          TOL_P17_F32_GRAD)
        except AssertionError:
            pass
        else:
            raise AssertionError(f"phase 19 {name}: the planted fault ({P19_FAULTS[name]}) passed "
                                 f"the f32 check (loss {fault['loss_err']:.3e}, gradient "
                                 f"{fault['grad_err']:.3e})")
    out["phase_s"] = time.monotonic() - t0
    print("MOE_TENSOR_SEQUENCE " + json.dumps(out), flush=True)
    print(f"  MoE over tensor and sequence phase: {out['phase_s']:.1f} s here ({card})", flush=True)
    return out


def main() -> int:
    t_run = time.monotonic()
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--group", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--lighthouse", help=argparse.SUPPRESS)
    parser.add_argument("--run-dir", help=argparse.SUPPRESS)
    parser.add_argument("--diloco-group", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    parser.add_argument("--heal-group", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--incarnation", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--elastic-group", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--durable-group", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--control-group", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--hsdp-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--p17-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--p18-rank", type=int, help=argparse.SUPPRESS)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from torchft_tpu_torch import _build
    from torchft_tpu_torch.ops import KERNELS

    if args.group is not None:
        run_group(args)
        return 0
    if args.diloco_group is not None:
        run_diloco_group(args)
        return 0
    if args.heal_group is not None:
        run_heal_group(args)
        return 0
    if args.elastic_group:
        run_elastic_group(args)
        return 0
    if args.durable_group is not None:
        run_durable_group(args)
        return 0
    if args.control_group is not None:
        run_control_group(args)
        return 0
    if args.hsdp_rank is not None:
        run_hsdp_rank(args)
        return 0
    if args.p17_rank is not None:
        run_p17_rank(args)
        return 0
    if args.p18_rank is not None:
        run_p18_rank(args)
        return 0

    # 1. Card.
    card = nvidia_smi_line()
    print(f"card: {card} ({torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible)", flush=True)

    # Each phase's wall time, printed as it ends (the run's limit is 1200 s).
    laps = [t_run]

    def lap(phase: str) -> None:
        laps.append(time.monotonic())
        print(f"phase {phase}: {laps[-1] - laps[-2]:.1f} s wall ({card})", flush=True)

    # 2. Build: the native core and the kernels at the same time.
    t0 = time.monotonic()
    with ThreadPoolExecutor(max_workers=1) as pool:
        native = pool.submit(_build.native_lib_path)
        _build.build_kernels()
        native.result()
    print(f"build: {time.monotonic() - t0:.1f} s wall; " + ", ".join(
        f"{k} {v:.1f} s" for k, v in sorted(_build.build_seconds.items())), flush=True)
    for name, log in sorted(_build.build_logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)
    check_spills(_build.build_logs)

    # 3. Kernel checks.
    print("kernel checks (flagship shapes):", flush=True)
    rec = kernel_checks()

    lap("1-3")

    # 4. The RMSNorm entry point.
    print("rms_norm_pallas entry point, flagship activations", flush=True)
    launches = {"rms_norm": rms_entry_point()["rms_norm"]}

    lap("4")

    # 5. Flagship training, on TCP lanes and then on shm lanes.
    print("main path: lighthouse + 2 replica groups, flagship config", flush=True)
    main_launches, _, tcp_run = main_path(card)
    launches.update(main_launches)
    missing = [n for n in KERNELS if launches.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on their paths: {missing}")
    print("main path over shm lanes: the same schedule, TPUFT_RING_TRANSPORT=shm in both "
          "groups", flush=True)
    shm_launches, _, shm_run = main_path(card, "shm")
    missing = [n for n in main_launches if shm_launches.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the shm run: {missing}")
    for name, run in (("tcp", tcp_run), ("shm", shm_run)):
        split = run["merged_split_ms"]
        print(f"merged step on {name} lanes (group 0): {run['merged_step_ms']:.1f} ms; copies off "
              f"the card {split['d2h_wait_s']:.1f} ms, ring wait {split['ring_wait_s']:.1f} ms, "
              f"copies back {split['h2d_s']:.1f} ms ({card})", flush=True)
    print(f"params_sha256 on shm lanes {shm_run['params_sha256']}, on TCP lanes "
          f"{tcp_run['params_sha256']}", flush=True)
    if shm_run["params_sha256"] != tcp_run["params_sha256"]:
        raise AssertionError("the shm run ended with other parameters than the TCP run")

    lap("5")

    # Legs run beside host-bound phases, each with processes (and launch
    # counts) of its own, joined at its phase's end and read at its own
    # phase: 17 (a), (b) then 19's legs (17's two rank processes) beside 6,
    # whose tiny models leave the card's memory to them, and from a side
    # thread 16 (c) beside 7, 17 (c) beside 9 and 10, 16 (a), (b), (d)
    # beside 11, and 18 (b) then (a) beside 12, 13 and 14.
    side_pool = ThreadPoolExecutor(max_workers=1)
    side = {}

    try:
        # 6. Kill and heal through the launcher and the train_ddp example.
        side["p17"] = p17_start()
        print("phase 17 (a) and (b), then phase 19's legs, started beside phase 6 (two rank "
              "processes over gloo)", flush=True)
        print("kill and heal: Launcher + train_ddp on the card, group 1 killed with SIGKILL",
              flush=True)
        kill_heal = kill_heal_phase(card)
        print(f"disk resume: Launcher + train_ddp --ckpt_dir, both groups stopped at step "
              f"{RESUME_STEPS} and resumed from disk", flush=True)
        resume_phase(card)
        p17_wait(side["p17"])
        print("  (phase 6's times were taken beside phase 17 (a), (b) and phase 19's rank "
              "processes)", flush=True)

        lap("6")

        # 7. The bare ring on the card's host.
        print(f"bare ring: 2 in-process ranks, the flagship's gradient payload, "
              f"{BARE_RING_REPEATS} allreduces a configuration on TCP and shm lanes; then max / "
              f"min, a shaped link, a {RING2D_RANKS}-rank ring2d and the ops beyond allreduce",
              flush=True)
        # Phase 16 (c), host-bound (process starts, the heal), beside it.
        hsdp_c = side_pool.submit(hsdp_kill, card)
        print("phase 16 (c) started beside phase 7: train_hsdp --model flagship, 2 groups x "
              "fsdp 2, under the launcher", flush=True)
        bare_ring(card, "phase 16 (c)'s processes (train_hsdp, 2 groups x fsdp 2)")
        hsdp_c = hsdp_c.result()

        lap("7")

        # 8. The raw-step profile.
        print(f"raw-step profile: torch.profiler over {PROFILE_STEPS} chained flagship full_steps",
              flush=True)
        profile_phase(card)

        lap("8")

        # 9. The semisync codec's device encoders, with phase 17 (c)'s drive
        # started beside phases 9 and 10 (its processes, launch counts and
        # result are its own; phase 17 reads them).
        p17c = side_pool.submit(p17_kill, card)
        print("phase 17 (c) started beside phases 9 and 10: train_pipeline --model flagship "
              "--schedule 1f1b, 2 groups x pipeline 2, under the launcher", flush=True)
        print("semisync codec: device int8 / int4 encoders against the host quantizers",
              flush=True)
        codec_phase(card)

        lap("9")

        # 10. Streaming DiLoCo on the flagship.
        print(f"DiLoCo: lighthouse + 2 groups, flagship width at {DILOCO_LAYERS} layers, "
              f"StreamingDiLoCo(sync_every="
              f"{DILOCO_SYNC_EVERY}, codec='int8'), group 1 heals into round "
              f"{DILOCO_SOLO_ROUNDS + 1}", flush=True)
        diloco_launches = diloco_phase(card)
        p17c_result = p17c.result()

        lap("10")

        # 11. The healing plane on the flagship.
        print(f"healing: lighthouse + 3 groups, flagship widths at {HEAL_LAYERS} layers, "
              "erasure-coded state k 2 m 1; "
              "a striped two-donor heal, an erasure heal, a donor killed mid-fetch", flush=True)
        in_group = side_pool.submit(hsdp_phase, card, kill=hsdp_c)
        print("phase 16 (a), (b) and (d) started beside phase 11", flush=True)
        healing_launches, heal_recovery = healing_phase(
            card, "phase 16 (a), (b), (d)'s processes (in-group ranks on gloo)")
        hsdp = in_group.result()

        lap("11")

        # Phase 18's legs, (b) then (a), beside phases 12-14 (bound by
        # process starts, heals and the lighthouses' timeouts); each of
        # those phases' lines names them.
        p18 = side_pool.submit(p18_legs, card)
        beside_18 = (f"{card}; taken beside phase 18 (b) and (a)'s processes (train_ring, 2 groups "
                     f"x sequence 2, then 2 ranks over gloo)")
        print("phase 18 (b) then (a) started beside phases 12, 13 and 14: train_ring --model "
              "flagship --layout zigzag, 2 groups x sequence 2, under the launcher; then ring, "
              "zigzag and Ulysses over sequence 2 against the flagship unsharded", flush=True)

        # 12. The elastic plane on the flagship.
        print(f"elastic: Launcher + 3 groups + 1 hot spare, flagship widths at {ELASTIC_LAYERS} "
              f"layers, elastic global batch "
              f"{ELASTIC_GLOBAL_BATCH} (microbatch {ELASTIC_MICROBATCH}); a cooperative drain, "
              f"then a SIGKILL, each handed to the spare, then a straggler rotated out by the "
              f"sentinel", flush=True)
        elastic_launches = elastic_phase(beside_18, {"heal": [heal_recovery["kill_b"],
                                                         heal_recovery["kill_c"]],
                                                "heal_beside": heal_recovery["beside"],
                                                "kill_heal": kill_heal["recovery_s"]})

        lap("12")

        # 13. Durable state and isolated communication on the flagship.
        print(f"durable state: lighthouse + 2 groups, flagship widths at {DURABLE_LAYERS} layers, "
              f"StatefulDataLoader; (a) "
              f"{DURABLE_STEPS} steps, (b) the same stopped at {DURABLE_STEPS // 2} and resumed "
              f"from disk, (c) a lost group healed over CollectiveTransport, (d) a baby "
              f"collective's child SIGKILLed", flush=True)
        durable_launches = durable_phase(beside_18, heal_recovery["http_striped"])

        lap("13")

        # 14. The highly-available and federated control plane on the flagship.
        print(f"control plane: (a) 2 HA lighthouse processes (lease {CONTROL_LEASE_MS} ms) + 2 "
              f"groups, flagship widths at {CONTROL_LAYERS} layers, the leader SIGKILLed after "
              f"{CONTROL_KILL_AT} merged steps; "
              f"(b) a root + 2 region lighthouses, one group in each, {CONTROL_STEPS} steps",
              flush=True)
        control_launches = control_phase(beside_18)
        p18_result = p18.result()

        lap("14")

        # 15. The step options on the flagship.
        print(f"step options: (a) {OPTION_STEPS} flagship full_steps with and without remat from "
              f"one seed; (b) one group alone, {OVERLAP_STEPS} ft_steps with overlap_commit True "
              f"and then False, the vote of step {OVERLAP_FAIL_AT} failed", flush=True)
        options = step_options_phase(card)

        lap("15")

        # 16. In-group parallelism and sharded healing on the flagship.
        print("in-group parallelism: (a) fsdp 2 and (b) tensor 2, two local ranks on the card over "
              "gloo, the flagship sharded against it unsharded; (c) train_hsdp, 2 groups x fsdp 2, "
              "group 1 SIGKILLed and its shards healed; (d) one rank over NCCL", flush=True)
        print(f"  (its legs ran beside phases 7 and 11: {hsdp['phase_s']:.1f} s for (a), (b) and "
              f"(d) there)", flush=True)

        lap("16")

        # 17. The mixture of experts and the pipeline on the flagship's widths.
        print(f"MoE and pipeline: (a) the flagship's widths with {MOE_EXPERTS} experts a block over "
              f"expert 2 against it unsharded, then {MOE_FT_STEPS} ft_steps under a Manager; (b) the "
              f"flagship over pipeline 2, GPipe and 1F1B against it unsharded, and each's peak at M "
              f"{PIPE_MEM_MICRO}; (c) train_pipeline --schedule 1f1b, 2 groups x pipeline 2, group 1 "
              f"SIGKILLed and healed stage by stage", flush=True)
        moe_pipe = p17_phase(card, ranks=side["p17"], kill=p17c_result)

        lap("17")

        # 18. Long context on the flagship.
        print("long context: (a) ring contiguous, ring zigzag and Ulysses over sequence 2 "
              "against the flagship unsharded, f32 then bf16, and a planted fault in each; (b) "
              "train_ring --layout zigzag, 2 groups x sequence 2, group 1 SIGKILLed and healed "
              "rank by rank", flush=True)
        print("  (its legs ran beside phases 12-14)", flush=True)
        long_context = p18_phase(card, p18_result)
    finally:
        if "p17" in side:
            _p17_stop(side["p17"])  # a phase between failed: no rank outlives the run
        side_pool.shutdown()  # a side drive ends by its own deadline and stops its processes

    lap("18")

    # 19. The mixture of experts over "tensor" and over "sequence".
    print(f"MoE over tensor and sequence: the flagship's widths with {MOE_EXPERTS} experts a block "
          f"(a) over tensor 2, (b) over sequence 2 under Ulysses, (c) under the zigzag ring, each "
          f"against it unsharded, f32 with a planted fault then bf16, then {MOE_FT_STEPS} "
          f"ft_steps under the Managers", flush=True)
    print("  (its legs ran in phase 17's rank processes, beside phase 6)", flush=True)
    moe_ts = p19_phase(card, side["p17"]["p19"])

    lap("19")

    # 20. The kernels line, then the last line.
    kernels = []
    for name, kern in KERNELS.items():
        r = rec[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"torchft_tpu_torch/csrc/{kern.source}.cu",
            "replaces": kern.replaces,
            "launches": launches[name],
            "launches_on": "rms_norm_pallas entry point" if name == "rms_norm"
                           else "flagship FT training",
            "launches_main_shm": shm_launches.get(name, 0),
            "launches_diloco": diloco_launches.get(name, 0),
            "launches_healing": healing_launches.get(name, 0),
            "launches_elastic": elastic_launches.get(name, 0),
            "launches_durable": durable_launches.get(name, 0),
            "launches_control": control_launches.get(name, 0),
            "launches_remat": options["remat"]["remat_True"]["launches"].get(name, 0),
            "launches_no_remat": options["remat"]["remat_False"]["launches"].get(name, 0),
            "launches_hsdp": hsdp["launches"].get(name, 0),
            "launches_moe": moe_pipe["moe"]["launches"].get(name, 0),
            "launches_pipeline": moe_pipe["pipe"]["launches"].get(name, 0),
            "launches_train_pipeline": moe_pipe["kill"]["launches"].get(name, 0),
            "launches_ring": long_context["launches"]["ring"].get(name, 0),
            "launches_ulysses": long_context["launches"]["ulysses"].get(name, 0),
            "launches_train_ring": long_context["kill"]["launches"].get(name, 0),
            "launches_moe_tensor": moe_ts["launches"]["tensor"].get(name, 0),
            "launches_moe_ulysses": moe_ts["launches"]["ulysses"].get(name, 0),
            "launches_moe_zigzag": moe_ts["launches"]["zigzag"].get(name, 0),
            "max_abs_err": r["max_abs_err"],
            "ref_rms": r["ref_rms"],
            "err_over_tol": r["err_over_tol"],
            "tol": r["tol"],
            "planted_faults_err_over_tol": r["planted"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **{k: r[k] for k in ("device_ms", "host_ms", "shapes", "library_call",
                                 "library_bf16w_ms", "matmul_ms", "plain_call", "checked",
                                 "bitwise_repeat")
               if k in r},
        })
    print(f"chip_smoke: {time.monotonic() - t_run:.1f} s in all ({card})", flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
