"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught).  Phases 1-6
run alone, so that the kernels' own times are taken on a quiet card.
Then the work runs in lanes at once: this process runs phases 9, 19, 11,
12 and 20 in that order; a child process runs phases 17, 18, 14 and 16,
another phases 7, 8, 10, 13 and 15, and phases 21 and 22 run in
children of their own (all four started after phase 6 and joined after
phase 20); the host checks of phases 3 and 19b run in children started
after their runs.  Every phase's host work is Python on one core and the
card idles most of each round, so the lanes share the card (a CUDA
context each) and the host's cores, and their times are taken so: a
round costs the host up to 1.7x what it costs alone.  A child's lines
are printed when it is joined; its failure fails the script, and the
script's failure stops it and every process it started.

1. Report the card (``nvidia-smi`` name and power limit, the torch
   device name) and build the CUDA kernels from ``tpu_paxos_torch/csrc``
   (one ``nvcc`` per source, started together).
2. Hold the general engine's kernels (``simkern``) against their plain
   PyTorch versions on the card, at the main path's shape (A=5, P=2,
   I=2**23) and at odd sizes, with exact equality (all protocol state is
   integer), ``store_accepts`` also on a full-size set shaped like a real
   round (batches on one 2**20 window per proposer, one proposer
   eligible nowhere), and time kernel and plain version with CUDA events (median
   of 25 launches; before each, the in-place operands are restored and
   the L2 is flushed, so every launch does a first launch's work),
   against the bytes these operands need (``simkern.bytes_needed``; the
   dense count, ``bytes_per_launch``, is printed beside it).
3. Drive the general engine's main path — ``tpu_paxos_torch.core.sim.run``
   at the ``"engine": "sim"`` bench configuration (5 nodes, 2**23
   instances, proposers (0, 1), assign_window 2**20, drop 500 / dup
   1000 / delay 0-2, seed 0) — with the launch counts zeroed just before
   and read just after; it must launch both kernels, pass the invariant
   checks and reproduce the committed JAX golden (rounds, chosen count,
   decision-log sha256, ``tpu_paxos_torch/data/goldens.json``).
   Then run it again, recording the operands of every simkern launch
   (about 12 GB on the card, freed before phase 5), and on each of those
   snapshots hold the kernel against its plain version exactly, time it
   (median of 9 launches, restored operands, cold L2) and count the
   32-byte sectors its operands need (``simkern.bytes_needed``): the
   sums over the run are each simkern record's ``main_path_ms`` and
   ``main_path_bound_ms``.  Each ``store_accepts`` line also gives the
   launch's live-batch share and the batch rows it reads.  The run's host
   checks (agreement and exactly-once through ``harness/validate``, and
   the decision log) are timed numpy against ``tpu_paxos_torch.native``
   in a child process beside the phases that follow (joined at the end:
   equal verdicts and log sha256, each side's host seconds printed).
4. Run the CLI-sized workload (``4 4 10`` with the debug.conf faults,
   gates on) through ``python -m tpu_paxos_torch``'s entry point; its
   decision log must match the second golden.
5. Hold the fast path's window kernel (``fastwin``) against its plain
   version, exactly (all five state fields and the counts), at the
   headline shape (A=5, I=2**27, 16 windows) for sequential and explicit
   vids, a span > I case and a no-quorum case, and the raw wrapper at
   I=2**20+7 and 80; time kernel and plain version (median of 10 calls)
   beside the bytes bound.
6. Drive the fast path's main path, the headline run
   ``steady_state_windows_fused(fast.init_state(2**27, 5), None,
   reps=16, quorum=3, iota_vids=True)``, three times, with the counts
   zeroed just before the first and read just after it: each host total
   must be exactly 2**31 and the last window's learned rows
   ``arange(I) + 15 * 2**27``.
7. Run ``python -m tpu_paxos_torch 5 8192 1024 --engine=fast --json``
   (2**23 instances); its stdout must equal the JAX CLI's golden.
8. Drive the general engine under correlated faults at bench_sim's size:
   the ``partition-flap`` and ``wan-3region`` mixes of
   ``tpu_paxos/harness/stress.py``, each with the counts zeroed before
   and read after; each must launch both simkern kernels, pass the
   invariant checks and reproduce its JAX golden (rounds, done, chosen
   count, decision-log and chosen-round sha256).
9. Drive the fleet runner (``fleet.runner.FleetRunner.run``) at
   ``bench.py``'s fleet configuration: 5 nodes, proposers (0, 1), the
   gated stress workload on 56 instances, ``max_rounds`` 20000, ring bound
   8, 128 lanes with sampled schedules, first under the headline knob
   cycle (seeds 0-127), then the delay-spread cycle (seeds 50000+) on the
   113 of its lanes that decide within ``DELAY_ROUNDS_MAX`` (1000) rounds
   or park (the 15 that duel for 1011-7988 rounds are left out: they
   cost 7000 round calls), each
   with the counts zeroed before and read after: both simkern kernels
   must launch on lane-stacked operands (all the dispatch's lanes a
   launch), every lane
   be ``ok``, and the six verdict fields and every lane's decision-log
   sha256 equal the JAX goldens.  Prints lanes/sec to verdict, rounds,
   ms and host syncs a round.  Then the headline again with every kernel
   launch held against its plain version on its own lane-stacked
   operands, timed and its needed bytes counted.  (The 2048-lane timing
   dispatch and its 8 single re-runs left this script for phase 19's time:
   ``tests/test_torch_fleet_cuda.py`` runs them in a call of their own.)
10. The runtime build at full width: one ``FleetRunner`` per mix at
   bench_sim's shape (2**23 instances), ``partition-flap`` as a runtime
   table with its knobs and ``wan-3region`` as its runtime edge matrices
   plus table, 2 lanes each.  Lane 0 runs the golden's seed and must
   reproduce phase 8's constant-path golden; lane 1 another seed and
   must equal the single ``sim.run(lane_cfg(1))`` on the card.  Every
   kernel launch is held against its plain version on its lane-stacked
   operands, timed and its needed bytes counted.
11. Failure triage on the card, each step against the JAX goldens
   (``stress_quick``, ``triage_wedge``, ``triage_full``):
   a. ``python -m tpu_paxos_torch.harness.stress --seeds 1 --triage-dir
      DIR`` (``make stress-quick``'s host-loop sweep over the 10 mixes,
      at the golden's one seed a mix) as a subprocess; its summary, less
      ``seconds``, must equal JAX's.
   b. Under ``TPU_PAXOS_SEEDED_WEDGE=takeover`` the pause-crash sweep
      (2 seeds) must find what JAX's finds (nothing); then the small
      ``culprit`` triage case (the three-episode ``decision_round_max``
      case) is shrunk on the card with the batched evaluator (8-lane
      dispatches; a seeded takeover wedge's shrink, artifact and replay
      are phase 17b's recall), with the
      counts zeroed before and read after: the final case, violation,
      moves and eval count must equal JAX's, both kernels must launch on
      8-lane operands, the written artifact must equal JAX's byte for
      byte (file sha256), and ``python -m tpu_paxos_torch repro <a>
      --json`` must exit 0 with stdout equal to JAX's (sha256).  Prints
      the shrink's wall, evals, dispatches and ms a round.  The culprit
      shrink is then run again with every 8-lane kernel launch held
      against its plain version on its own operands, timed and its
      needed bytes counted.
   c. Full width: ``bench_sim_partition_flap`` (2**23 instances) with
      ``decision_round_max`` one below its last decision, shrunk with
      ``shrink_case(max_evals=3, batch=False)`` (one-lane runtime runs at
      2**23), then ``save_artifact``: the final case, violation, moves,
      evals, the artifact's decision-log sha256 and rounds and the file's
      sha256 must equal JAX's.  Prints the peak device memory.  Its CLI
      ``repro`` runs beside 12d's traces, and its ``match`` and stdout
      sha256 must equal JAX's.
12. The flight recorder on the card, against the JAX goldens
   (``telemetry``), with phase 12's own seconds:
   a. ``sim.run_with_telemetry`` (``window_rounds`` 16) at full width on
      ``bench_sim``, ``bench_sim_partition_flap`` and ``bench_sim_wan3``
      (the last with the WAN3 region map and names), each with the
      counts zeroed before and read after: the decision-log sha256 must
      equal the plain golden and ``summary_to_dict(summary, windows)``
      JAX's, key for key, and both simkern kernels must launch; on
      ``bench_sim`` every launch is held against its plain version on its
      own operands.
   b. ``bench_sim``'s round loop alone, plain and armed in turns (plain,
      armed, armed, plain): ms and host syncs a round; the syncs a round
      must be equal.
   c. The fleet's headline cycle at 128 lanes (phase 9's configuration),
      plain and armed (``FleetRunner(telemetry=True)``, ``run(regions=)``
      cycling the WAN3 map, the WAN5 map and None) in turns: every armed
      lane's ``lane_telemetry(i)`` (sha256 of its sorted compact JSON)
      and decision-log sha256 must equal the goldens, both kernels
      launch on 128-lane operands, and the syncs a round must be equal;
      prints lanes/s, ms and syncs a round of each.
   d. ``python -m tpu_paxos_torch trace <basename> --stdout`` in three
      subprocesses at once, in each artifact's directory, on the two committed
      artifacts (``tpu_paxos_torch/data/repro_{culprit,takeover}.json``,
      the latter with the seeded wedge armed) and on 11c's 2**23
      artifact, with 11c's ``repro`` started beside them: each stdout's
      sha256 must equal JAX's and the artifact's bytes stay unchanged.
13. The schedule search, the fleet stress sweep and the geometry-padded
   envelope on the card, against the JAX goldens (``search``,
   ``stress_fleet``, ``envelope``), with phase 13's own seconds:
   a. ``python -m tpu_paxos_torch fleet --lanes 8 --generations 1 --seed 2
      --decision-round-max 35 --max-wedges 1 --triage-dir DIR --quiet``
      (``make fleet-quick``'s arguments) as a subprocess, started beside
      13c's: its summary,
      less ``seconds``, ``lanes_per_sec`` and ``shrink_seconds``, must
      equal JAX's, the wedge artifact must equal JAX's byte for byte
      (file sha256) and ``python -m tpu_paxos_torch repro`` on it must
      exit 0 with JAX's stdout (sha256).
   b. ``fleet.search.main`` at the card's default 128 lanes with
      ``--generations 2 --seed 0 --gray --wan`` (no triage directory),
      with the counts zeroed before and read after: the summary less the
      timing keys (every generation's margins, causes and per-lane causes
      included) must equal JAX's and both kernels must launch on 128-lane
      operands.  Prints lanes/s, ms and host syncs a round.
   c. What ``python -m tpu_paxos_torch.harness.stress --fleet --seeds 8
      --triage-dir DIR`` runs, in this process: the fleet sweep at 8 seeds
      and (cut since PR 10) the host-loop sweep of the i.i.d. mixes at one
      seed a mix; both summaries, less ``seconds``, ``lanes_per_sec`` and
      ``compiles_per_mix``, must equal JAX's (the per-mix ``telemetry``
      blocks key for key).  Prints the fleet's lanes/s.
   d. ``bench.py``'s geometry-padded envelope configuration (menu 3/(0,),
      5/(0,1), 7/(0,1,2); three 8-value rows on 48 instances,
      ``max_rounds`` 4000; 64 lanes; both protocol configs and both
      rates): one ``runner_for(..., geometry=)`` serves all 12 cells (one
      runner built), with the counts zeroed before and read after; each
      lane's rounds, verdict and decision-log sha256 must equal JAX's and
      its bound-free twin's on the card, and both kernels launch on
      64-lane (A, P) = (7, 3) operands (the run-time-loop build).  Then
      the padding toll: lanes/s at each true geometry, padded and
      unpadded in turns; and one padded dispatch at 7 nodes with every
      kernel launch held against its plain version, timed and its needed
      bytes counted.

14. Membership on the card, against the JAX goldens (``member``), with
   phase 14's own seconds and the kernel launch counts of the phase (the
   membership path runs none of the three kernels):
   a. BASELINE config 5 at its literal size: ``ChurnEngine(7, 2**20,
      churn=grow_shrink_schedule(7, 5, values_per_step=1),
      max_rounds=4000)`` with ``.run`` (decided from the tensors) and
      ``.run_host`` (decided from numpy reads) at seeds 5, 6 and 7: rounds,
      ``done``, ``injected``, the decision-log and chosen-round sha256 must
      equal JAX's, and the two drivers' final states must be equal; then
      ``MemberSim(7, 2**20)`` through the literal-size scenario of
      ``tests/test_membership.py`` must equal its golden.  Prints each run's
      wall, rounds, ms and host syncs a round and peak device memory.
   b. ``python -m tpu_paxos_torch 4 4 10 --engine=member --json
      --record-injections F``, then ``--replay-injections F``, and the same
      line with ``--crash-rate=5000``, as subprocesses: each stdout and the
      injection log's text must equal JAX's.
   c. ``MemberSim(7, 2**20)``: crash node 2, checkpoint (port-written),
      rejoin from it, record the injections and replay them; the replay
      must equal the run, and the run its golden (rounds, decision-log
      sha256, injection ops); restoring the checkpoint into a state of
      the wrong geometry must raise.
   d. The member fleet at the envelope ``evolve --axis member`` runs (3
      nodes, 8 instances, 200 rounds), 128 lanes drawn with
      ``sample_churn_schedule`` and ``sample_member_schedule`` from
      ``np.random.default_rng(0)``: every lane's verdict and decision-log
      sha256 must equal JAX's; prints lanes/s, ms and host syncs a round.
      Then one ``geometry=`` padded runner on menu 3/5 at 3 and at 5 true
      nodes must equal its bound-free twin lane for lane.

15. Open-loop serving on the card, against the JAX goldens (``serve``),
   with phase 15's own seconds; every run prints its wall, ms and host
   syncs a round, values/s (lanes/s for the fleet), peak device memory
   and kernel launches:
   a. ``serve_full`` (``bench.py:1229``'s record at its on-TPU size):
      ``serve/harness.serve_run`` of 2**16 Poisson values (16000 milli,
      seed 0) on 2**17 instances, 5 nodes, drop 500 / dup 1000 / delay
      0-2, 2-round windows, 32 a dispatch, 128-round buckets, SLO 64
      rounds / budget 100, with the counts zeroed before and read after:
      every report field but the wall, the summary and SLO dicts and the
      decision-log sha256 must equal JAX's, and both kernels must launch
      on one-lane operands; then the first two dispatches again, with the
      first 16 launches of each kernel held against its plain version on
      their own operands, timed and their needed bytes counted.
   b. ``serve_twins_4096`` (``BENCH_serve.json``'s configuration, 2**12
      values on 2**13 instances): the pipelined run (32 windows a
      dispatch), the sequential baseline (1) and the unwindowed plain
      twin each equal JAX's, and ``sweep_load`` at 8000-64000 milli (less
      the wall fields, knee included) equals JAX's.
   c. ``serve_fleet_256`` (``bench.py:1500``'s record at its on-TPU
      size): ``serve/fleet.serve_fleet_run`` of 256 lanes from
      ``fleet_lanes`` (2**12 values on 2**13 instances each) at 32000 and
      then 128000 milli: per lane the decision-log sha256, decided count,
      breach flag and first breach dispatch, the host-confirmed verdicts
      of the flagged lanes, rounds, dispatches and ``done`` must equal
      JAX's, both kernels launching on 256-lane operands; in the 128000
      run the first 16 launches of each kernel are copied and, after it,
      held against the plain version; and the 1-lane zero-load fleet must
      make the closed-loop ``sim.run``'s decision log (and JAX's).
   d. ``python -m tpu_paxos_torch serve``, ``serve --fleet --lanes 8``,
      ``trace --serve --stdout`` and ``trace --serve --stdout --lanes 4
      --lane 1`` as four subprocesses started together with 15a: the
      serve lines less the wall fields and the trace stdout's sha256 must
      equal the JAX CLI's.

16. The admission controller on the card, against the JAX goldens
   (``control``), with phase 16's own seconds:
   a. ``control_ab_bench``: ``serve/control.spike_ab`` at ``bench.py``'s
      ``bench_serve_control_record`` configuration (3 nodes, 2048
      instances, assign_window 8, 1000 values at 2000 milli spiked 4x over
      the middle half, arrivals at seed 0 on an engine at seed 3, 4-round
      windows, 2 a dispatch, 32-round buckets, SLO 16 rounds / budget 150),
      run twice with the saved artifact replayed: the second run builds no
      runner (``envelope.cache_misses``), and its off and on points,
      breach windows, sheds, decisions, gray-shed violations and replay
      sha256 equal the committed ``BENCH_serve_control.json``.
   b. ``control_spike_full``: one armed ``controlled_serve_run`` at 15a's
      width (2**16 values from ``spike_rounds`` at 16000 milli, factor 4,
      on 2**17 instances; ``spike_ab``'s shed-only policy), with the counts
      zeroed before and read after: the report, its decisions, shed
      records (sha256), summary, SLO dict and combined decision-log sha256
      equal JAX's, both kernels launch on one-lane operands; then the
      first two dispatches again with the first 16 launches of each kernel
      held against the plain version.
   c. ``control_fleet_256``: ``controlled_fleet_run`` at 15c's 128000-milli
      cell (256 lanes, 2**12 values on 2**13 instances each): per lane the
      decisions, sheds, breach flags and combined decision-log sha256
      equal JAX's, both kernels launch on 256-lane operands, and the first
      16 launches of each kernel are copied in the run and held after it.
   d. ``serve --control --save-artifact``, ``serve --control-ab`` and
      ``serve --fleet --lanes 8 --control`` (with SLOs) as subprocesses in
      one directory, started together with ``repro`` and ``trace`` of the
      committed ``artifacts/serve_control_spike.json``: the serve lines
      less the wall fields, the saved artifact's bytes and each stdout's
      sha256 equal the JAX CLI's; then ``repro`` of the saved artifact.

17. Model checking on the card, against the committed certificates and
   the JAX goldens (``mc``), with phase 17's own seconds:
   a. The four quick scopes (quick, gray, churn, control) in ``make
      mc-quick``'s order, envelopes cold, each through
      ``modelcheck.run_for(scope)(scope, device="cuda")``, the quick scope
      cut to its first 16 of 58 chunks (``chunk_limit``; its verdict bits
      and counts then the prefix of the certificate's and JAX's): the verdict bits,
      counts and chunk geometry equal the certificate (compared on the
      card: the port's check has no backend gate), the summary less
      timing and device equals JAX's, ``compiles_per_chunk`` has JAX's
      zero pattern (quick builds in chunk 0, gray rides quick's envelope,
      churn builds in chunk 0, control in its first e2e cell), no
      anomalies; wall, lanes/s, ms and syncs a round per scope, both
      kernels launching on 16-lane operands (one-lane in control's e2e
      cells, none in churn's member fleet).  Within the quick scope's own
      run, each lane of its first two chunks has JAX's decision-log
      sha256, and the first 16 launches of each kernel are held against
      the plain version and timed on snapshots of their own operands
      once the run has ended.
   b. Recall.  The fault scope: ``mc --scope quick`` with
      ``TPU_PAXOS_SEEDED_WEDGE=takeover``, one counterexample shrunk into
      a triage dir (a subprocess started with 17a): its summary, its
      certificate failure (naming scenario 220) and
      ``mc_scenario_220.json``'s bytes equal JAX's, and ``repro`` of it
      prints JAX's stdout.  The controller: ``shed-on-gray`` on the tiny
      host scope of ``tests/test_mc_control.py``: the summaries and the
      three mc-control artifacts equal JAX's byte for byte; ``repro``,
      ``repro --json`` and ``trace --stdout`` of the first, the variable
      unset, print JAX's stdout with its exit code.
   c. (Cut for phase 20's room: the full scope's first two chunks, whose
      verdict bits are the certificate's prefix, run in
      ``tests/test_torch_mc_cuda.py``, and the whole scope outside.)
   d. ``mc --scope gray --json`` (its line less timing and device equals
      JAX's, the zero pattern kept) and ``mc --scope nosuch`` (exit 2),
      subprocesses started with 17a.

18. The selection loop on the card, against the JAX goldens (``evolve``),
   with phase 18's own seconds.  Every run starts from a cold envelope;
   ``compiles_per_generation`` counts runner builds, so its value in
   generation 0 is the port's, and its zero pattern JAX's.
   a. ``make evolve-quick``'s line (8 lanes, 2 generations, seed 2, the
      synthetic bound at round 35, one wedge) through ``python -m
      tpu_paxos_torch evolve`` in this process: the summary less the wall
      fields, the shrunk artifact's bytes and ``repro`` of it equal JAX's;
      both kernels launch on 8-lane operands, and the first 16 launches of
      each are held against the plain version (on snapshots of their
      operands, after the run).
   b. The pure operators' seeded sweep; the member axis (4 lanes, 2
      generations, duel-churn; no kernel launches), the serve axis (6
      lanes, 3 generations, saturation; its first 16 launches of each
      kernel held) and the one-lane ``lane_causes`` case: populations,
      wedges, causes, burns and triage files equal JAX's.
   c. The card's default population: ``evolve --lanes 128 --generations 2
      --seed 0 --hunt duel-churn``; the summary less the wall fields equals
      JAX's; lanes/s, ms and syncs a round.
   d. The certified recall (``BENCH_evolve.json``'s contract) is not run
      here: its wedged lanes run 20,096 rounds in a generation dispatch, the
      single re-run, the shrinker's dispatches and the replay, far past this
      script's time limit.  ``tests/test_torch_evolve_cuda.py`` holds it on
      the card in a call of its own.

19. The instance-sharded engines on the card, against the JAX goldens at
   8 devices, with phase 19's own seconds.  The mesh's 8 ranks are
   threads of this process, all on the one card (``cuda:0``), exchanging
   through a ``torch.distributed`` ``HashStore`` they share on the host:
   no multi-chip and no NCCL number is measured.
   a. ``parallel/sharded_sim.run_sharded`` at ``bench.py``'s sharded record
      configuration (7 nodes, 2**20 instances, proposers (0, 1), seed 0,
      ``assign_window`` 16384, drop 500 / dup 1000 / delay 0-2,
      ``max_rounds`` 20000) on 8 ranks, the launch counts kept per rank:
      the invariant checks hold, both kernels launch on every rank, and
      the rounds, chosen count, decision-log, chosen-round and every
      result array's sha256 equal JAX's (``sharded_sim_2p20_d8``).  Prints
      wall, ms and host syncs a round, collectives a round, peak memory.
      Then the same run on the (2, 4) ``("dcn", "i")`` mesh must equal it
      bit for bit (and ``sharded_sim_2p20_2x4``), with the first 16
      launches of each kernel on every rank held against the plain
      version on their own ``[.., I_loc]`` operands, timed and their
      needed bytes counted.
   b. ``parallel/sharded.sharded_choose_all`` over 7 nodes and 1e8
      instances on 8 ranks (about 8.4 GB of state), twice: ``n_chosen``
      exactly 1e8, every rank's learned rows equal to its vids, the
      replicated scalars equal on every rank; instances/s printed as 8
      ranks on one card.  The host checks of the 1e8 run's first 2**24
      instances (validation and their decision log), numpy against
      native, run in a child process
      beside the rest of the script (joined at the end: equal verdicts
      and log sha256, host seconds printed).  Then 1e7 on the (2, 4) mesh:
      every gathered FastState field equals JAX's (``sharded_fast``).
   c. ``python -m tpu_paxos_torch 5 8192 1024 --engine=fast --mesh 8
      --json`` and ``repro --json`` of the committed JAX-written
      ``tpu_paxos_torch/data/repro_sharded_d8.json``, two subprocesses
      started with 19a: each stdout equals the JAX CLI's.  (``4 4 10 ...
      --mesh 8`` left the script for phase 20's room:
      ``tests/test_torch_sharded_cuda.py`` runs it.)
   The whole sharded stress sweep (12 runs at 8 ranks) runs in a call of
   its own: ``tests/test_torch_sharded_cuda.py``.

20. The lane tile on the card: a fleet's lane axis split over 8 ranks of
   one mesh (threads of this process, all on ``cuda:0``, rank ``r`` running
   lanes ``[16 r, 16 r + 16)``; lanes are independent, so the tile makes
   no collective), with phase 20's own seconds.  It measures the tile's
   correctness and cost on one card, not multi-chip scaling.
   a. Phase 9's headline cycle (``fleet_headline_128``) on the tile, 16
      lanes a rank: the verdict vectors and every lane's decision-log
      sha256 equal phase 9's JAX golden, both kernels launch on every rank
      (the counts of this run, kept per rank, printed), and the first 16
      launches of each kernel on every rank are held against the plain
      version on their own operands, timed and their needed bytes
      counted.  Prints wall, ms and host syncs a rank-round, lanes/s and
      peak memory.
   b. and c. run in a call of their own, past this script's time
      (``tests/test_torch_lane_tile_cuda.py``, through this script's
      ``run_tile_serve``, ``run_tile_certificate`` and the tiled CLIs):
      phase 15c's 256-lane serve fleet at its 128000-milli cell on the
      tile, its record equal to 15c's golden; the shard certificate's four
      lane drivers at D = 8 and on the (2, 4) mesh equal to
      ``tpu_paxos_torch/analysis/shard_certificate.json``; ``fleet --mesh
      8`` (fleet-quick's arguments) and ``serve --fleet --lanes 8 --mesh
      8``, printing JAX's summaries less the wall fields.  The same call
      runs the 256-lane controlled fleet (16c) and the 128-lane member
      fleet (14d) on the tile.

21. The audit on the card (``python -m tpu_paxos_torch audit --device
   cuda``'s ``analysis/audit.run_audit``), in a child process started
   after phase 6 and joined after phase 20, beside phases 7-20: every
   registered entry point (the JAX package's 28 names) runs its
   canonical small run once; its kernel launches a round must equal the
   kernel calls a round pinned on the CPU
   (``tpu_paxos_torch/analysis/launch_budget.json``), its rounds, host
   reads and collectives the pinned counts, and its host syncs (torch's
   sync debug mode, per process) the budget's ``cuda`` caps.  Prints each
   entry's launches, syncs, collectives and host reads a round, and the
   phase's own seconds.

22. The library surface on the card, in a child process started after
   phase 6 and joined after phase 20, beside phases 7-21: a. bench_sim untraced and then under ``utils/log.profile_trace``
   (``torch.profiler``, CUDA activity): both decision logs equal phase
   1's golden, the trace's ``store_accepts``/``accum_acks`` kernel events
   equal the launch counters, and ``SimResult.rounds_to_chosen`` (length,
   sum, max, sha256) and ``value_status`` of three vids equal JAX's
   (``library.bench_sim``); prints the traced and untraced ms a round.
   b. The fast path's headline (16 windows of 2**27) under the profiler:
   16 ``window_kernel`` events, equal to the launch counter; the fast CLI
   at 2**23 with ``--trace-dir``: stdout the untraced golden's.  (The
   fast CLI runs ``fast.choose_all``, which launches no window kernel, as
   JAX's does; the headline is the window kernel's path.)  c.
   ``harness/reference_runner.run_equivalent_sim(4, 4, 10)`` at seeds
   0-2: rounds and every SimResult array equal JAX's, the reference's
   checker holds.  d. The five examples (``python -m
   tpu_paxos_torch.examples.<name> --device cuda``) print their JAX
   twins' lines.  e. ``scripts/torch_replay_diff_member.py --device
   cuda``: the replay's decision log is byte-identical to the recording's.
   f. ``scripts/torch_check_smoke.py --device cuda``: one tiny config per
   engine under ``CUDA_LAUNCH_BLOCKING=1``, its invariants held and its
   decision log equal to the normal run's (``compute-sanitizer`` refuses
   the card's machine, so its pass has no phase).  d-f run after a-c as
   processes of their own, two at a time.

The line before the last is a JSON object with one record per kernel;
the last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
SCALAR_OPS_PER_S = 67e12  # H100 SXM 32-bit rate outside the tensor cores
A, P, I_FULL = 5, 2, 1 << 23
REPS = 25
SNAP_REPS = 9  # launches timed on each main-path snapshot
DELAY_ROUNDS_MAX = 1000  # the delay cycle's lanes run: those deciding within this many rounds
FULL_REPS = 3  # launches timed on each full-width runtime-lane snapshot
TRIAGE_REPS = 3  # launches timed on each 8-lane shrink-dispatch snapshot
L2_FLUSH_BYTES = 1 << 30
I_FW, WINDOWS, FW_REPS = 1 << 27, 16, 10  # the fast path's headline shape
DEV = "cuda"


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _rand_inputs(i: int, seed: int):
    """Seeded acceptor/proposer arrays with realistic NONE density and
    ballot ties between the accepted ballots and the proposers' ballots."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    dev = DEV

    def rint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=torch.int32)

    def coin(prob, shape):
        return torch.rand(shape, generator=g, device=dev) < prob

    ballots = torch.tensor([65536, 65537, 131072, 131073, 196608], dtype=torch.int32, device=dev)
    acc_ballot = torch.where(coin(0.3, (A, i)), ballots[rint(0, 5, (A, i)).long()], -1)
    acc_vid = torch.where(acc_ballot != -1, rint(0, 1 << 23, (A, i)), -1)
    learned = torch.where(coin(0.2, (A, i)), rint(0, 1 << 23, (A, i)), -1)
    # some batches agree with the accepted / learned values (store-or-match)
    batch = torch.where(coin(0.7, (P, i)), rint(0, 1 << 23, (P, i)), -1)
    batch = torch.where(coin(0.2, (P, i)), acc_vid[:P], batch)
    batch = torch.where(coin(0.1, (P, i)), learned[:P], batch)
    abal = ballots[torch.tensor([1, 2], device=dev)]
    elig = coin(0.6, (P, A))
    elig[:, 0] = True
    acks = coin(0.2, (P, A, i)).to(torch.int8)
    return acc_ballot, acc_vid, learned, batch.contiguous(), abal, elig, acks


def _round_store_inputs(i: int, seed: int):
    """store_accepts operands shaped like a real round at full size: each
    proposer's batches on one assignment window of 2**20 instances with
    NONE elsewhere, acceptors holding (at the proposer's ballot or a
    higher one) or having learned some of proposer 0's, and proposer 1
    eligible at no acceptor, so one batch row is read."""
    acc_ballot, acc_vid, learned, _, abal, elig, _ = _rand_inputs(i, seed)
    g = torch.Generator(device=DEV).manual_seed(seed)
    win = 1 << 20
    batch = torch.full((P, i), -1, dtype=torch.int32, device=DEV)
    for p in range(P):
        w0 = int(torch.randint(0, i // win, (1,), generator=g, device=DEV)) * win
        batch[p, w0:w0 + win] = torch.randint(
            0, 1 << 23, (win,), generator=g, device=DEV, dtype=torch.int32)
    for a in range(A):
        pick = (batch[0] != -1) & (torch.rand(i, generator=g, device=DEV) < 0.5)
        hold = pick & (torch.rand(i, generator=g, device=DEV) < 0.7)
        higher = torch.rand(i, generator=g, device=DEV) < 0.3
        acc_vid[a] = torch.where(hold, batch[0], acc_vid[a])
        acc_ballot[a] = torch.where(hold, torch.where(higher, abal[1], abal[0]), acc_ballot[a])
        learned[a] = torch.where(pick & ~hold, batch[0], learned[a])
    elig[1] = False
    return acc_ballot, acc_vid, learned, batch, abal, elig


def _store_shape(ops) -> tuple[float, int]:
    """A store_accepts operand set's live-batch share (instances where a
    batch row the kernel reads holds a batch) and the batch rows it reads
    (the proposers eligible at some acceptor)."""
    abat, elig = ops[3], ops[5]
    rows = elig.any(dim=1)
    live = (abat[rows] != -1).any(dim=0)
    return float(live.float().mean()), int(rows.sum())


def _flusher():
    """A setup step that reads a buffer twenty times the 50 MB L2, so the
    next launch finds its operands in device memory, as the main path
    does at 2**23.  It keeps the card busy for about 0.3 ms, longer than
    the wrapper's host work, so the events time the kernel alone."""
    buf = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=DEV)
    return buf.sum


def _median_ms(fn, reps: int = REPS, setup=None) -> float:
    """Median CUDA-event time of ``fn``; ``setup`` runs before each timed
    launch, outside the events."""
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def time_in_place(fn, ops, in_place, reps: int = REPS) -> float:
    """Median time of ``fn(*work)`` where ``work`` is a copy of ``ops``
    whose in-place operands (indices ``in_place``) are restored from
    ``ops`` before every launch, and the L2 flushed: each launch does a
    first launch's work on cold operands, and nothing compounds."""
    work = [t.clone() if k in in_place else t for k, t in enumerate(ops)]
    flush = _flusher()

    def setup():
        for k in in_place:
            work[k].copy_(ops[k])
        flush()

    return _median_ms(lambda: fn(*work), reps, setup)


def _max_abs_err(pairs) -> int:
    err = 0
    for got, want in pairs:
        if not torch.equal(got, want):
            err = max(err, int((got.to(torch.int64) - want.to(torch.int64)).abs().max()))
            if err == 0:
                err = 1  # shape or dtype mismatch
    return err


def check_kernels(sk) -> dict:
    """Phase 2: kernel == plain version, exactly, at full and odd sizes;
    times at the main path's shape."""
    rec = {}
    for i in (I_FULL, I_FULL + 7, 80):
        ab, av, lr, bat, abal, elig, acks = _rand_inputs(i, seed=i)
        want = sk.store_accepts_plain(ab, av, lr, bat, abal, elig)
        got = sk.store_accepts_cuda(ab.clone(), av.clone(), lr, bat, abal, elig)
        torch.cuda.synchronize()
        err_s = _max_abs_err(zip(got, want))
        want = sk.accum_acks_plain(acks, bat, ab, av, lr, abal, elig)
        got = sk.accum_acks_cuda(acks.clone(), bat, ab, av, lr, abal, elig)
        torch.cuda.synchronize()
        err_a = _max_abs_err(zip(got, want))
        print(f"kernels vs plain at A={A} P={P} I={i}: store_accepts max_abs_err={err_s} "
              f"accum_acks max_abs_err={err_a}")
        if err_s or err_a:
            raise SystemExit(f"kernel disagrees with its plain version at I={i}")
        if i != I_FULL:
            continue
        store_ops = (ab, av, lr, bat, abal, elig)
        ack_ops = (acks, bat, ab, av, lr, abal, elig)
        rec["simkern.store_accepts"] = {
            "max_abs_err": err_s,
            "ms": time_in_place(sk.store_accepts_cuda, store_ops, (0, 1)),
            "plain_ms": _median_ms(lambda: sk.store_accepts_plain(*store_ops), setup=_flusher()),
            "dense_bytes": sk.bytes_per_launch("store_accepts", A, P, i),
            "bytes": sk.bytes_needed("store_accepts", *store_ops),
            "ops": 8 * A * P * i,
        }
        rec["simkern.accum_acks"] = {
            "max_abs_err": err_a,
            "ms": time_in_place(sk.accum_acks_cuda, ack_ops, (0,)),
            "plain_ms": _median_ms(lambda: sk.accum_acks_plain(*ack_ops), setup=_flusher()),
            "dense_bytes": sk.bytes_per_launch("accum_acks", A, P, i),
            "bytes": sk.bytes_needed("accum_acks", *ack_ops),
            "ops": 9 * A * P * i,
        }
        del store_ops, ack_ops
    ops = _round_store_inputs(I_FULL, seed=1)
    want = sk.store_accepts_plain(*ops)
    got = sk.store_accepts_cuda(ops[0].clone(), ops[1].clone(), *ops[2:])
    torch.cuda.synchronize()
    err = _max_abs_err(zip(got, want))
    share, rows = _store_shape(ops)
    b = sk.bytes_needed("store_accepts", *ops)
    print(f"store_accepts vs plain on a round-shaped set at A={A} P={P} I={I_FULL} "
          f"(live share {share:.4f}, {rows} batch row read): max_abs_err={err}, kernel "
          f"{time_in_place(sk.store_accepts_cuda, ops, (0, 1)):.4f} ms, needs {b} bytes "
          f"(bound {b / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    if err:
        raise SystemExit("store_accepts disagrees with its plain version on the round-shaped set")
    rec["simkern.store_accepts"]["max_abs_err"] = max(rec["simkern.store_accepts"]["max_abs_err"], err)
    del ops, want, got
    for name, r in rec.items():
        r["bytes_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
        r["ops_ms"] = r["ops"] / SCALAR_OPS_PER_S * 1e3
        print(f"{name}: needs {r['bytes']} bytes/launch of {r['dense_bytes']} dense "
              f"({r['dense_bytes'] / I_FULL:.1f} B/instance), kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, bytes bound {r['bytes_ms']:.4f} ms "
              f"({r['bytes_ms'] / r['ms']:.1%} of bound; dense "
              f"{r['dense_bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    torch.cuda.empty_cache()
    return rec


def _bench_cfg(gold):
    from tpu_paxos_torch import config as cfgm

    bc = gold["config"]
    return cfgm.SimConfig(
        n_nodes=bc["n_nodes"], n_instances=bc["n_instances"],
        proposers=tuple(bc["proposers"]), seed=bc["seed"],
        assign_window=bc["assign_window"], max_rounds=bc["max_rounds"],
        faults=cfgm.FaultConfig(**bc["faults"]),
    )


def _check_bench_sim(res, cfg, gold) -> str:
    from tpu_paxos_torch.replay.decision_log import decision_log, sha256

    sha = sha256(decision_log(res.chosen_vid, res.chosen_ballot, gold["stride"], cfg.n_instances))
    chosen = int((res.chosen_vid != -1).sum())
    if (res.rounds, bool(res.done), chosen, sha) != (
        gold["rounds"], gold["done"], gold["chosen"], gold["decision_log_sha256"]
    ):
        raise SystemExit(f"main path disagrees with the JAX golden: {gold}")
    return sha


def run_main_path(sk, goldens) -> dict:
    """Phase 3: the full-size general-engine run on the card."""
    from tpu_paxos_torch.core import sim
    from tpu_paxos_torch.harness import validate

    gold = goldens["bench_sim"]
    cfg = _bench_cfg(gold)
    torch.cuda.reset_peak_memory_stats()
    sk.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sim.run(cfg, device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    chosen = int((res.chosen_vid != -1).sum())
    print(f"main path (sim.run, I={cfg.n_instances}): rounds={res.rounds} done={res.done} "
          f"chosen={chosen} wall_s={wall:.3f} peak_mem_gb={peak_gb:.2f} "
          f"launches={json.dumps(launches, sort_keys=True)}")
    validate.check_all(res.learned, res.expected_vids)
    print("main path invariants: agreement, exactly_once, executed_identical")
    sha = _check_bench_sim(res, cfg, gold)
    print(f"main path decision_log_sha256={sha} (matches the JAX golden)")
    for name, n in launches.items():
        if n < 1:
            raise SystemExit(f"kernel simkern.{name} was never launched on the main path")
    return launches, start_native_compare(
        {"learned": res.learned, "chosen_vid": res.chosen_vid,
         "chosen_ballot": res.chosen_ballot},
        gold["stride"], cfg.n_instances, f"phase 3, bench_sim at I={cfg.n_instances}",
        _card_line())


@contextlib.contextmanager
def _wrapping(sk, wrap):
    """Within the block both simkern kernel wrappers are replaced by
    ``wrap(name, kernel)``; the originals come back after it."""
    kernels = {"store_accepts": sk.store_accepts_cuda, "accum_acks": sk.accum_acks_cuda}
    sk.store_accepts_cuda = wrap("store_accepts", kernels["store_accepts"])
    sk.accum_acks_cuda = wrap("accum_acks", kernels["accum_acks"])
    try:
        yield
    finally:
        sk.store_accepts_cuda = kernels["store_accepts"]
        sk.accum_acks_cuda = kernels["accum_acks"]


@contextlib.contextmanager
def capture_operands(sk):
    """Record a clone of every simkern launch's operands, as the kernel
    is given them (before its in-place update), by kernel name; a
    one-lane launch's without its lane axis."""
    snaps = {"store_accepts": [], "accum_acks": []}

    def recording(name, kernel):
        lane_ndim = 3 if name == "store_accepts" else 4

        def launch(*ops):
            # a single run launches on one lane: keep its operands as
            # one run's, the shapes an older one-run build takes
            one = ops[0].ndim == lane_ndim and ops[0].shape[0] == 1
            snaps[name].append([t[0].clone() if one else t.clone() for t in ops])
            return kernel(*ops)
        return launch

    with _wrapping(sk, recording):
        yield snaps


def snapshot_main_path(sk, goldens, launches) -> dict:
    """Phase 3b: a second bench_sim run that records every kernel
    launch's operands (the timed run above stays a plain run)."""
    from tpu_paxos_torch.core import sim

    gold = goldens["bench_sim"]
    cfg = _bench_cfg(gold)
    with capture_operands(sk) as snaps:
        res = sim.run(cfg, device=DEV)
    torch.cuda.synchronize()
    _check_bench_sim(res, cfg, gold)
    counts = {k: len(v) for k, v in snaps.items()}
    gb = sum(t.numel() * t.element_size() for v in snaps.values() for ops in v for t in ops) / 1e9
    print(f"main path snapshots: {json.dumps(counts, sort_keys=True)} launches, {gb:.2f} GB on the card")
    if counts != launches:
        raise SystemExit(f"snapshot run launched {counts}, the main path {launches}")
    return snaps


def time_main_path_operands(sk, snaps) -> dict:
    """Phase 3c: each kernel on each main-path snapshot: equal to its
    plain version, timed (median of SNAP_REPS launches from restored
    operands and a cold L2), and the bytes those operands need."""
    out = {}
    kernels = {  # kernel, plain version, in-place operand indices
        "store_accepts": (sk.store_accepts_cuda, sk.store_accepts_plain, (0, 1)),
        "accum_acks": (sk.accum_acks_cuda, sk.accum_acks_plain, (0,)),
    }
    for key, (kern, plain, in_place) in kernels.items():
        ms = needed = 0
        for n, ops in enumerate(snaps[key]):
            want = plain(*ops)
            got = kern(*[t.clone() if k in in_place else t for k, t in enumerate(ops)])
            torch.cuda.synchronize()
            if _max_abs_err(zip(got, want)):
                raise SystemExit(f"simkern.{key} disagrees with its plain version on main-path launch {n}")
            t = time_in_place(kern, ops, in_place, SNAP_REPS)
            b = sk.bytes_needed(key, *ops)
            ms += t
            needed += b
            shape = ""
            if key == "store_accepts":
                share, rows = _store_shape(ops)
                shape = f", live share {share:.4f}, {rows} batch rows read"
            print(f"main path simkern.{key} launch {n}: {t:.4f} ms, needs {b} bytes "
                  f"(bound {b / HBM_BYTES_PER_S * 1e3:.4f} ms){shape}")
            del want, got
        bound = needed / HBM_BYTES_PER_S * 1e3
        out[f"simkern.{key}"] = {"main_path_ms": ms, "main_path_bound_ms": bound}
        print(f"main path simkern.{key}: {len(snaps[key])} launches, {ms:.4f} ms in all, "
              f"needed bytes {needed} -> bound {bound:.4f} ms ({bound / ms:.1%} of bound)")
    return out


def run_cli(sk, goldens) -> None:
    """Phase 4: the CLI-sized run through the port's CLI entry point."""
    from tpu_paxos_torch import __main__ as cli
    from tpu_paxos_torch.replay.decision_log import sha256

    gold = goldens["cli_4_4_10"]
    f = gold["faults"]
    argv = [str(x) for x in gold["args"]] + [
        "--seed=0", f"--net-drop-rate={f['drop_rate']}",
        f"--net-dup-rate={f['dup_rate']}", f"--net-max-delay={f['max_delay']}",
        "--device=cuda",
    ]
    sk.reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    lines = buf.getvalue().splitlines(keepends=True)
    sha = sha256("".join(lines[:-1]))
    print(f"cli {' '.join(argv)}: rc={rc} launches={json.dumps(dict(sk.LAUNCHES), sort_keys=True)} "
          f"decision_log_sha256={sha}")
    print(f"cli verdict: {lines[-1].strip()}")
    if rc != 0 or sha != gold["decision_log_sha256"]:
        raise SystemExit("CLI-sized run disagrees with its JAX golden")


def _fw_state(fast, i: int, blocked: bool = False):
    """A headline-shape FastState on the card with stale acceptor
    contents (every cell is overwritten by the windows); ``blocked``
    makes 3 of 5 acceptors promise a ballot above the proposer's."""
    st = fast.init_state(i, A, device=DEV)
    g = torch.Generator(device=DEV).manual_seed(i)
    for t in (st.acc_ballot, st.acc_vid, st.learned):
        t.random_(0, 1 << 20, generator=g)
    if blocked:
        st.promised[:3] = 10 << 16
    return st


def _fw_compare(fw, fast, i, iota, blocked=False, span=None, reps=WINDOWS):
    """Kernel (raw wrapper) vs plain version from one state: returns the
    max abs error over the five fields and the counts, the kernel's
    state and its scalars."""
    base = _fw_state(fast, i, blocked)
    vids = torch.arange(i, dtype=torch.int32, device=DEV)
    span = span or i
    copy = fast.FastState(*[t.clone() for t in base])
    want, want_cnt = fw.steady_state_windows_plain(copy, vids, reps, 3, span)
    got = base
    scal = fw.window_scalars(got, 3, span)
    cnt = fw.steady_state_windows_cuda(
        got.acc_ballot, got.acc_vid, got.learned, None if iota else vids, scal, reps)
    torch.cuda.synchronize()
    err = _max_abs_err(list(zip(got, want)) + [(cnt, want_cnt)])
    total = int(cnt.to(torch.int64).sum())
    del want, want_cnt
    return err, total, got, scal


def check_fastwin(fw, fast) -> dict:
    """Phase 5: the window kernel == its plain version, exactly, at the
    headline shape and at odd sizes; times at the headline shape."""
    rec = {"max_abs_err": 0}
    cases = [
        ("iota", I_FW, dict(iota=True)),
        ("explicit", I_FW, dict(iota=False)),
        ("span_gt_I", I_FW, dict(iota=False, span=4 * I_FW, reps=4)),
        ("no_quorum", I_FW, dict(iota=True, blocked=True)),
        ("odd_2p20+7", (1 << 20) + 7, dict(iota=False)),
        ("odd_2p20+7_iota", (1 << 20) + 7, dict(iota=True)),
        ("odd_80", 80, dict(iota=False)),
    ]
    for label, i, kw in cases:
        err, total, st, scal = _fw_compare(fw, fast, i, **kw)
        reps = kw.get("reps", WINDOWS)
        print(f"fastwin vs plain [{label}] A={A} I={i} reps={reps}: max_abs_err={err} "
              f"chosen_total={total} scal={scal.tolist()[:4]}")
        expect = 0 if kw.get("blocked") else reps * i
        if err or total != expect:
            raise SystemExit(f"fastwin kernel disagrees with its plain version [{label}]")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if i == I_FW and label in ("iota", "explicit"):
            vids = None if kw["iota"] else torch.arange(i, dtype=torch.int32, device=DEV)
            ms = _median_ms(lambda: fw.steady_state_windows_cuda(
                st.acc_ballot, st.acc_vid, st.learned, vids, scal, WINDOWS), FW_REPS)
            plain_vids = torch.arange(i, dtype=torch.int32, device=DEV)
            plain_ms = _median_ms(lambda: fw.steady_state_windows_plain(
                st, plain_vids, WINDOWS, 3), FW_REPS)
            # each window's launch writes the state once; vids are read
            # once per call (the roofline count), not once per window
            byts = WINDOWS * fw.bytes_per_launch(A, i, True) + (0 if kw["iota"] else 4 * i)
            rec[label] = {
                "ms": ms, "plain_ms": plain_ms, "bytes": byts,
                "bytes_ms": byts / HBM_BYTES_PER_S * 1e3,
                "ops_ms": WINDOWS * 4 * A * i / SCALAR_OPS_PER_S * 1e3,
            }
            print(f"fastwin [{label}] {WINDOWS} windows: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bytes {byts} -> bytes bound "
                  f"{rec[label]['bytes_ms']:.4f} ms ({byts / ms / 1e9:.3f} TB/s)")
            if ms < rec[label]["bytes_ms"]:
                raise SystemExit("fastwin kernel ran under its bytes bound: stores were dropped")
            del plain_vids, vids
        del st, scal
        torch.cuda.empty_cache()
    return rec


def run_fast_headline(fw, fast, card) -> int:
    """Phase 6: the fast path's main path, the headline window run,
    three times (the counts are zeroed before the first and read after
    it; the others show the spread)."""
    launches = 0
    for k in range(3):
        st = fast.init_state(I_FW, A, device=DEV)
        torch.cuda.synchronize()
        if k == 0:
            fw.reset_counts()
        t0 = time.perf_counter()
        st, counts = fw.steady_state_windows_fused(st, None, reps=WINDOWS, quorum=3, iota_vids=True)
        total = int(counts.cpu().to(torch.int64).sum())
        wall = time.perf_counter() - t0
        if k == 0:
            launches = fw.LAUNCHES["steady_state_windows"]
        last = torch.arange(I_FW, dtype=torch.int32, device=DEV) + (WINDOWS - 1) * I_FW
        rows_ok = all(torch.equal(st.learned[a], last) for a in range(A))
        print(f"fast headline {k + 1}/3 (steady_state_windows_fused, A={A}, I={I_FW}, "
              f"reps={WINDOWS}, iota): total={total} launches={launches} wall_s={wall:.4f} "
              f"instances_per_s={total / wall:.4e} last_window_rows_ok={rows_ok} | {card}")
        # 16 windows of 2**27 sequential vids fill the int32 vid space: 2**31
        if total != WINDOWS * I_FW or not rows_ok:
            raise SystemExit(f"fast headline run disagrees: total must be {WINDOWS * I_FW}")
        del st, last, counts
    if launches < 1:
        raise SystemExit("kernel fastwin.steady_state_windows was never launched on its path")
    torch.cuda.empty_cache()
    return launches


def run_fast_cli(goldens) -> None:
    """Phase 7: the fast CLI at 2**23 instances."""
    from tpu_paxos_torch import __main__ as cli

    gold = goldens["fast_cli_2p23"]
    argv = list(gold["args"]) + [f"--device={DEV}"]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    print(f"fast cli {' '.join(argv)}: rc={rc} wall_s={wall:.3f} stdout={buf.getvalue().strip()}")
    if rc != 0 or buf.getvalue() != gold["stdout"]:
        raise SystemExit("fast CLI disagrees with its JAX golden")


def _rebuild_faults(cfgm, flt, d: dict):
    d = dict(d)
    if "schedule" in d:
        d["schedule"] = flt.FaultSchedule.from_dict(d["schedule"])
    if "edges" in d:
        d["edges"] = cfgm.EdgeFaultConfig.from_dict(d["edges"])
    return cfgm.FaultConfig(**d)


def _golden_cfg(bc: dict):
    """A golden's bench-shaped config, its faults (schedule and edge
    tables included) rebuilt from plain JSON."""
    from tpu_paxos_torch import config as cfgm
    from tpu_paxos_torch.core import faults as flt

    return cfgm.SimConfig(
        n_nodes=bc["n_nodes"], n_instances=bc["n_instances"],
        proposers=tuple(bc["proposers"]), seed=bc["seed"],
        assign_window=bc["assign_window"], max_rounds=bc["max_rounds"],
        faults=_rebuild_faults(cfgm, flt, bc["faults"]),
    )


def run_scheduled(sk, goldens, key: str) -> dict:
    """Phase 8: one bench-size general-engine run under a stress mix."""
    import hashlib

    import numpy as np

    from tpu_paxos_torch.core import sim
    from tpu_paxos_torch.harness import validate
    from tpu_paxos_torch.replay.decision_log import decision_log, sha256

    gold = goldens[key]
    bc = gold["config"]
    cfg = _golden_cfg(bc)
    torch.cuda.synchronize()
    sk.reset_counts()
    t0 = time.perf_counter()
    res = sim.run(cfg, device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)
    sha = sha256(decision_log(res.chosen_vid, res.chosen_ballot, gold["stride"], cfg.n_instances))
    rsha = hashlib.sha256(np.asarray(res.chosen_round, "<i4").tobytes()).hexdigest()
    chosen = int((res.chosen_vid != -1).sum())
    print(f"{key} ({bc['mix']}, I={cfg.n_instances}): rounds={res.rounds} done={res.done} "
          f"chosen={chosen} wall_s={wall:.3f} launches={json.dumps(launches, sort_keys=True)} "
          f"decision_log_sha256={sha} chosen_round_sha256={rsha}")
    validate.check_all(res.learned, res.expected_vids)
    if (res.rounds, bool(res.done), chosen, sha, rsha) != (
        gold["rounds"], gold["done"], gold["chosen"], gold["decision_log_sha256"],
        gold["chosen_round_sha256"],
    ):
        raise SystemExit(f"{key} disagrees with its JAX golden")
    for name, n in launches.items():
        if n < 1:
            raise SystemExit(f"kernel simkern.{name} was never launched on {key}")
    return launches


def _hold_snapshot(sk, name: str, kern, snap, reps: int, stats: dict) -> None:
    """One launch's snapshot held against the plain version, timed
    (``reps`` launches from restored operands and a cold L2) and its
    needed bytes counted into ``stats[name]``; the comparison launches
    leave ``sk.LAUNCHES`` as they found it."""
    plain, in_place = {
        "store_accepts": (sk.store_accepts_plain, (0, 1)),
        "accum_acks": (sk.accum_acks_plain, (0,)),
    }[name]
    counts = dict(sk.LAUNCHES)
    want = plain(*snap)
    got = kern(*[t.clone() if k in in_place else t for k, t in enumerate(snap)])
    torch.cuda.synchronize()
    st = stats.setdefault(name, {"launches": 0, "lanes": set(), "ms": [], "bytes": 0,
                                 "max_abs_err": 0})
    st["max_abs_err"] = max(st["max_abs_err"], _max_abs_err(zip(got, want)))
    st["ms"].append(time_in_place(kern, snap, in_place, reps))
    st["bytes"] += sk.bytes_needed(name, *snap)
    st["launches"] += 1
    st["lanes"].add(int(snap[0].shape[0]))
    sk.LAUNCHES.update(counts)


@contextlib.contextmanager
def check_launches(sk, reps: int, stats: dict, lanes: int | None = None,
                   limit: int | None = None, defer: bool = False, held: dict | None = None):
    """Every simkern launch in the block (of ``lanes`` lanes, when given;
    the first ``limit`` of each kernel, when given, on each mesh rank) is
    held against its plain version on a snapshot of its operands, timed
    on it (``reps`` launches from restored operands and a cold L2) and
    its needed bytes counted: before the real launch goes ahead, or, with
    ``defer``, once the block has ended (the block's own wall, syncs and
    peak memory then carry only the snapshots' copies).  The comparison
    launches leave ``sk.LAUNCHES`` as they found it.  ``stats[name]``
    gathers the launches, their lane counts, times, needed bytes and the
    largest error; ``held``, when given, gets the launches held per
    ``(mesh rank or None, kernel)``."""
    from tpu_paxos_torch.parallel import mesh as pmesh

    taken = {}
    pending = []

    def hold(name, kern, snap):
        _hold_snapshot(sk, name, kern, snap, reps, stats)

    def checking(name, kern):
        def launch(*ops):
            key = (pmesh.current_rank(), name)
            if lanes is not None and int(ops[0].shape[0]) != lanes:
                return kern(*ops)
            if limit is not None and taken.get(key, 0) >= limit:
                return kern(*ops)
            taken[key] = taken.get(key, 0) + 1
            snap = [t.clone() for t in ops]
            if defer:
                pending.append((name, kern, snap))
            else:
                hold(name, kern, snap)
                del snap
            return kern(*ops)
        return launch

    with _wrapping(sk, checking):
        yield stats
    if held is not None:
        held.update(taken)
    for job in pending:
        hold(*job)
    pending.clear()


def _summarize_checked(label: str, stats: dict) -> dict:
    out = {}
    for name, st in sorted(stats.items()):
        if st["max_abs_err"]:
            raise SystemExit(f"simkern.{name} disagrees with its plain version on {label}")
        ms = sorted(st["ms"])
        rec = {
            "launches": st["launches"], "lanes": sorted(st["lanes"]),
            "ms": sum(ms), "median_ms": ms[len(ms) // 2],
            "bound_ms": st["bytes"] / HBM_BYTES_PER_S * 1e3, "max_abs_err": st["max_abs_err"],
        }
        out[f"simkern.{name}"] = rec
        print(f"{label} simkern.{name}: {rec['launches']} launches of {rec['lanes']} lanes, "
              f"{rec['ms']:.4f} ms in all (median {rec['median_ms']:.4f} ms a launch), needed "
              f"bytes {st['bytes']} -> bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_ms'] / rec['ms']:.1%} of bound), max_abs_err={rec['max_abs_err']}")
    return out


@contextlib.contextmanager
def lane_counts(sk):
    """The lane count of every simkern launch in the block, by kernel."""
    seen = {"store_accepts": [], "accum_acks": []}

    def recording(name, kernel):
        lane_ndim = 3 if name == "store_accepts" else 4

        def launch(*ops):
            seen[name].append(int(ops[0].shape[0]) if ops[0].ndim == lane_ndim else 0)
            return kernel(*ops)
        return launch

    with _wrapping(sk, recording):
        yield seen


def count_syncs(fn) -> int:
    """Synchronizing CUDA calls made by ``fn()`` (``utils/device.counting_syncs``)."""
    from tpu_paxos_torch.utils import device as devm

    with devm.counting_syncs() as syncs:
        fn()
    return syncs.n


def _lane_sha(rep, i: int, stride: int) -> str:
    from tpu_paxos_torch.replay.decision_log import decision_log, sha256

    r = rep.lane_result(i)
    return sha256(decision_log(r.chosen_vid, r.chosen_ballot, stride, rep.cfg.n_instances))


def _same_result(a, b) -> bool:
    fields = ("learned", "chosen_vid", "chosen_round", "chosen_ballot", "crashed", "msgs")
    return (a.rounds, a.done) == (b.rounds, b.done) and all(
        (getattr(a, f) == getattr(b, f)).all() for f in fields
    )


def _fleet_config(goldens):
    """Phase 9's configuration, workload and gates (``bench.py``'s fleet
    cell)."""
    import numpy as np

    from tpu_paxos_torch import config as cfgm
    from tpu_paxos_torch.harness import stress

    c = goldens["fleet"]["config"]
    wl, gates, _ = stress._workload(2, np.random.default_rng(0))
    cfg = cfgm.SimConfig(
        n_nodes=c["n_nodes"], n_instances=c["n_instances"], proposers=tuple(c["proposers"]),
        seed=c["seed"], max_rounds=c["max_rounds"], faults=cfgm.FaultConfig(**c["faults"]),
    )
    return cfg, wl, gates


def _fleet_cycle(goldens, name: str):
    """The seeds, sampled schedules and knob mixes of phase 9's 128 lanes
    under its ``name`` cycle (``headline`` or ``delay``)."""
    import numpy as np

    from tpu_paxos_torch import config as cfgm
    from tpu_paxos_torch.fleet import search

    gold = goldens["fleet"]
    n = gold["config"]["lanes"]
    rng = np.random.default_rng(1)
    scheds = [search.sample_schedule(rng, 5, 4, 96) for _ in range(n)]
    gc = gold[name]
    mixes = gc["knob_mixes"]
    knobs = [cfgm.FaultConfig(**mixes[i % len(mixes)]) for i in range(n)]
    return [gc["first_seed"] + i for i in range(n)], scheds, knobs


def run_fleet(sk, goldens, card) -> dict:
    """Phase 9: the fleet runner at bench.py's fleet configuration."""
    import numpy as np

    from tpu_paxos_torch.fleet import runner as frun

    gold = goldens["fleet"]
    n = gold["config"]["lanes"]
    cfg, wl, gates = _fleet_config(goldens)
    runner = frun.FleetRunner(cfg, wl, gates, device=DEV)

    out = {}
    for name in ("headline", "delay"):
        gc = gold[name]
        seeds, sch, knobs = _fleet_cycle(goldens, name)
        # the delay cycle runs its lanes that decide within DELAY_ROUNDS_MAX
        # rounds and those that park (a fixed subset, chosen by the golden)
        sub = list(range(n)) if name == "headline" else [
            i for i, r in enumerate(gc["rounds"])
            if r <= DELAY_ROUNDS_MAX or r > cfg.max_rounds]
        seeds, sch, knobs = ([x[i] for i in sub] for x in (seeds, sch, knobs))
        m = len(sub)
        torch.cuda.synchronize()
        sk.reset_counts()
        with lane_counts(sk) as shapes:
            rep = runner.run(seeds, sch, knobs=knobs)
        launches = dict(sk.LAUNCHES)
        v = rep.verdict
        bad = [f for f in v._fields
               if np.asarray(getattr(v, f)).tolist() != [gc[f][i] for i in sub]]
        shas = [_lane_sha(rep, k, gold["stride"]) for k in range(m)]
        off = [i for k, i in enumerate(sub) if shas[k] != gc["decision_log_sha256"][i]]
        lanes_ok = all(s == [m] * len(s) for s in shapes.values())
        print(f"fleet [{name}] {m} of {n} lanes (I={cfg.n_instances}): lanes_per_sec={rep.lanes_per_sec:.2f} "
              f"seconds={rep.seconds:.3f} rounds_max={int(v.rounds.max())} iterations={rep.iterations} "
              f"ms_per_round={rep.seconds / rep.iterations * 1e3:.3f} ok={int(v.ok.sum())}/{n} "
              f"launches={json.dumps(launches, sort_keys=True)} lanes_per_launch_ok={lanes_ok} "
              f"verdict_fields_off={bad} decision_log_off={off} | {card}")
        if bad or off or not v.ok.all():
            raise SystemExit(f"fleet [{name}] disagrees with its JAX golden")
        if min(launches.values()) < 1 or not lanes_ok:
            raise SystemExit(f"fleet [{name}]: a simkern kernel did not launch on {m}-lane operands")
        out[name] = {"launches": launches, "iterations": rep.iterations, "seconds": rep.seconds,
                     "lanes_per_sec": rep.lanes_per_sec}

    # the headline again, outside the timed runs: its syncs counted (a
    # warning each) and its launches' operands copied, each held after it
    seeds, sch, knobs = _fleet_cycle(goldens, "headline")
    stats, it = {}, {}
    with check_launches(sk, SNAP_REPS, stats, defer=True):
        syncs = count_syncs(lambda: it.setdefault("rep", runner.run(seeds, sch, knobs=knobs)))
    rep = it["rep"]
    out["headline"]["syncs_per_round"] = syncs / rep.iterations
    out["headline"]["checked_seconds"] = rep.seconds
    print(f"fleet [headline] host syncs: {syncs} in {rep.iterations} rounds "
          f"({out['headline']['syncs_per_round']:.2f} a round); this run, its syncs counted and "
          f"its launches' operands copied: seconds={rep.seconds:.3f} ms_per_round="
          f"{rep.seconds / rep.iterations * 1e3:.3f}")
    if [_lane_sha(rep, i, gold["stride"]) for i in range(n)] != gold["headline"]["decision_log_sha256"]:
        raise SystemExit("fleet [headline] rerun disagrees with its JAX golden")
    out["checked"] = _summarize_checked(f"fleet [headline] {n}-lane operands", stats)

    # the 2048-lane timing dispatch and its single re-runs run in a call
    # of their own: tests/test_torch_fleet_cuda.py
    del rep
    torch.cuda.empty_cache()
    return out


def run_runtime_full(sk, goldens) -> dict:
    """Phase 10: the runtime-schedule, runtime-knob build at bench_sim's
    width, two lanes per mix."""
    import dataclasses
    import hashlib

    import numpy as np

    from tpu_paxos_torch import config as cfgm
    from tpu_paxos_torch.core import faults as flt
    from tpu_paxos_torch.core import sim
    from tpu_paxos_torch.fleet import envelope
    from tpu_paxos_torch.fleet import runner as frun
    from tpu_paxos_torch.harness import validate
    from tpu_paxos_torch.replay.decision_log import decision_log, sha256

    stats = {}
    for key in ("bench_sim_partition_flap", "bench_sim_wan3"):
        gold = goldens[key]
        bc = gold["config"]
        fc = _rebuild_faults(cfgm, flt, bc["faults"])
        knob = dataclasses.replace(fc, schedule=None)
        cfg = cfgm.SimConfig(
            n_nodes=bc["n_nodes"], n_instances=bc["n_instances"],
            proposers=tuple(bc["proposers"]), seed=bc["seed"],
            assign_window=bc["assign_window"], max_rounds=bc["max_rounds"],
            faults=cfgm.FaultConfig(max_delay=max(fc.max_delay, envelope.MAX_DELAY_BOUND)),
        )
        runner = frun.FleetRunner(cfg, sim.default_workload(cfg), device=DEV)
        seeds = [bc["seed"], bc["seed"] + 1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with check_launches(sk, FULL_REPS, stats):
            rep = runner.run(seeds, [fc.schedule] * 2, knobs=[knob] * 2)
        wall = time.perf_counter() - t0
        r0 = rep.lane_result(0)
        sha = sha256(decision_log(r0.chosen_vid, r0.chosen_ballot, gold["stride"], cfg.n_instances))
        rsha = hashlib.sha256(np.asarray(r0.chosen_round, "<i4").tobytes()).hexdigest()
        chosen = int((r0.chosen_vid != -1).sum())
        validate.check_all(r0.learned, r0.expected_vids)
        print(f"{key} runtime lanes (I={cfg.n_instances}, ring bound {cfg.faults.max_delay}): "
              f"lane 0 rounds={r0.rounds} done={r0.done} chosen={chosen} decision_log_sha256={sha} "
              f"chosen_round_sha256={rsha}; verdict ok={rep.verdict.ok.tolist()} "
              f"rounds={rep.verdict.rounds.tolist()} wall_s={wall:.3f} (kernel checks included)")
        if (r0.rounds, bool(r0.done), chosen, sha, rsha) != (
            gold["rounds"], gold["done"], gold["chosen"], gold["decision_log_sha256"],
            gold["chosen_round_sha256"],
        ):
            raise SystemExit(f"{key} runtime lane 0 disagrees with the constant-path golden")
        r1, lane_cfg = rep.lane_result(1), rep.lane_cfg(1)
        del rep
        single = sim.run(lane_cfg, device=DEV)
        same = _same_result(r1, single)
        print(f"{key} runtime lane 1 (seed {seeds[1]}) vs single sim.run: rounds={single.rounds} "
              f"equal={same}")
        if not same:
            raise SystemExit(f"{key} runtime lane 1 disagrees with its single run")
        del single, r1
        torch.cuda.empty_cache()
    return _summarize_checked("runtime lanes at full width (2 mixes)", stats)


def _port_env(here: str, extra: dict | None = None) -> dict:
    env = dict(os.environ, **(extra or {}))
    env["PYTHONPATH"] = os.pathsep.join(
        [here] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def _file_sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@contextlib.contextmanager
def _armed(env: dict):
    """``env`` set within the block, the envelope cache cleared on the
    way in and out (the seeded-wedge flag is part of its key)."""
    from tpu_paxos_torch.fleet import envelope

    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    envelope.clear_cache()
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        envelope.clear_cache()


@contextlib.contextmanager
def dispatch_log(single: list | None = None):
    """(lanes, round calls, seconds) of every fleet, member-fleet and
    controlled-serve dispatch in the block; with ``single``, every one-lane
    ``sim.run`` (a flagged lane's re-run, a replay) is logged there too."""
    from tpu_paxos_torch.core import sim
    from tpu_paxos_torch.fleet import member_runner as mrun
    from tpu_paxos_torch.fleet import runner as frun
    from tpu_paxos_torch.serve import control as ctl

    seen = []
    real = (frun.FleetRunner.run, mrun.MemberFleetRunner.run, ctl.controlled_serve_run, sim.run)

    def fleet(self, *a, **kw):
        rep = real[0](self, *a, **kw)
        seen.append((rep.n_lanes, rep.iterations, rep.seconds))
        return rep

    def member(self, *a, **kw):
        rep = real[1](self, *a, **kw)
        seen.append((rep.n_lanes, rep.iterations, rep.seconds))
        return rep

    def serve(*a, **kw):
        t0 = time.perf_counter()
        rep = real[2](*a, **kw)
        seen.append((1, rep.rounds, time.perf_counter() - t0))
        return rep

    def one(*a, **kw):
        t0 = time.perf_counter()
        res = real[3](*a, **kw)
        single.append((1, int(res.rounds), time.perf_counter() - t0))
        return res

    frun.FleetRunner.run, mrun.MemberFleetRunner.run, ctl.controlled_serve_run = fleet, member, serve
    if single is not None:
        sim.run = one
    try:
        yield seen
    finally:
        frun.FleetRunner.run, mrun.MemberFleetRunner.run, ctl.controlled_serve_run = real[:3]
        sim.run = real[3]


class _Moves:
    """A logger keeping the shrinker's accepted moves."""

    def __init__(self):
        self.moves = []

    def info(self, fmt, *args):
        self.moves.append(fmt % args)


def _repro_start(here: str, path: str, env: dict):
    """Starts ``python -m tpu_paxos_torch repro <basename> --json`` in the
    artifact's directory, as the JAX golden's replay was run; returns the
    process and its start time."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_paxos_torch", "repro", os.path.basename(path), "--json",
         "--device", DEV],
        cwd=os.path.dirname(path), env=_port_env(here, env), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
    )
    return proc, time.perf_counter()


def _repro_wait(started):
    """The finished replay of :func:`_repro_start` and its wall seconds."""
    proc, t0 = started
    stdout, stderr = proc.communicate(timeout=600)
    return subprocess.CompletedProcess(proc.args, proc.returncode, stdout, stderr), \
        time.perf_counter() - t0


def _repro_cli(here: str, path: str, env: dict):
    """The replay through the CLI, waited for."""
    return _repro_wait(_repro_start(here, path, env))


def run_stress_quick(goldens, here: str, card: str) -> dict:
    """Phase 11a: ``make stress-quick``'s sweep on the card, as a
    subprocess, at the golden's seed count."""
    gold = goldens["stress_quick"]["summary"]
    seeds = gold["seeds_per_mix"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_paxos_torch.harness.stress", "--seeds",
             str(seeds), "--triage-dir", tmp, "--device", DEV],
            cwd=here, env=_port_env(here), capture_output=True, text=True, timeout=900,
        )
        wall = time.perf_counter() - t0
        left = sorted(os.listdir(tmp))
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    less = {k: v for k, v in summary.items() if k != "seconds"}
    print(f"stress-quick (python -m tpu_paxos_torch.harness.stress --seeds {seeds}): "
          f"rc={proc.returncode} wall_s={wall:.3f} sweep_seconds={summary.get('seconds')} "
          f"summary={json.dumps(less, sort_keys=True)} artifacts={left} | {card}")
    if proc.returncode != 0 or less != gold:
        print(proc.stderr[-3000:], file=sys.stderr)
        raise SystemExit("stress-quick disagrees with its JAX golden")
    return {"wall_s": wall, "sweep_s": summary.get("seconds")}


def _case_from_spec(shr, spec):
    import numpy as np

    return shr.ReproCase(
        cfg=shr._cfg_from_dict(spec["cfg"]),
        workload=[np.asarray(w, np.int32) for w in spec["workload"]],
        gates=None if spec["gates"] is None else [np.asarray(g, np.int32) for g in spec["gates"]],
        chains=[np.asarray(c, np.int32) for c in spec["chains"]],
        extra_checks=dict(spec["extra_checks"]),
    )


def _shrink_on_card(sk, shr, case, max_evals: int, batch: bool):
    """One timed ``shrink_case`` on the card, with the counts zeroed just
    before and read just after, every launch's lane count and every fleet
    dispatch recorded."""
    moves, stats = _Moves(), {}
    torch.cuda.synchronize()
    sk.reset_counts()
    with lane_counts(sk) as shapes, dispatch_log() as disp:
        t0 = time.perf_counter()
        small, viol = shr.shrink_case(case, max_evals=max_evals, logger=moves, batch=batch,
                                      stats=stats, device=DEV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {
        "small": small, "violation": viol, "moves": moves.moves, "evals": stats["evals"],
        "wall_s": wall, "dispatches": disp, "lanes": {k: sorted(set(v)) for k, v in shapes.items()},
        "launches": dict(sk.LAUNCHES),
    }


def _hold_shrink(shr, got: dict, gold: dict, label: str) -> None:
    want = (gold["final_cfg"], gold["violation"], gold["moves"], gold["evals"])
    if (shr._cfg_to_dict(got["small"].cfg), got["violation"], got["moves"], got["evals"]) != want:
        raise SystemExit(f"{label}: the shrink disagrees with its JAX golden "
                         f"({got['violation']!r}, {got['moves']}, {got['evals']} evals)")


def _print_shrink(label: str, got: dict, card: str) -> None:
    disp = got["dispatches"]
    rounds = sum(d[1] for d in disp)
    secs = sum(d[2] for d in disp)
    by_lanes = {}
    for n, _, _ in disp:
        by_lanes[n] = by_lanes.get(n, 0) + 1
    print(f"{label} shrink on the card: wall_s={got['wall_s']:.3f} evals={got['evals']} "
          f"dispatches={json.dumps(by_lanes, sort_keys=True)} (lanes: count) round_calls={rounds} "
          f"dispatch_s={secs:.3f} ms_per_round={secs / max(rounds, 1) * 1e3:.3f} "
          f"launches={json.dumps(got['launches'], sort_keys=True)} "
          f"launch_lanes={json.dumps(got['lanes'], sort_keys=True)} moves={got['moves']} "
          f"violation={got['violation']!r} | {card}")


def _save(shr, got: dict, gold: dict, tmp: str, label: str) -> dict:
    """Phases 11b-c: save the shrunk case and compare the file with JAX's."""
    path = os.path.join(tmp, gold["artifact"])
    t0 = time.perf_counter()
    art = shr.save_artifact(path, got["small"], got["violation"], device=DEV)
    save_s = time.perf_counter() - t0
    sha = _file_sha256(path)
    print(f"{label} artifact {gold['artifact']}: save_s={save_s:.3f} file_sha256={sha} "
          f"decision_log_sha256={art['decision_log_sha256']} rounds={art['rounds']}")
    if (sha, art["decision_log_sha256"], art["rounds"]) != (
        gold["artifact_sha256"], gold["decision_log_sha256"], gold["rounds"]
    ):
        raise SystemExit(f"{label}: the artifact differs from JAX's")
    return {"save_s": save_s, "path": path}


def _replay(here: str, path: str, gold: dict, env: dict, label: str):
    """Phases 11b-c: starts the artifact's replay through the CLI; returns
    a function that waits for it, holds it against JAX's and gives its
    wall seconds."""
    started = _repro_start(here, path, env)

    def finish() -> float:
        proc, cli_s = _repro_wait(started)
        out_sha = hashlib.sha256(proc.stdout.encode()).hexdigest()
        verdict = json.loads(proc.stdout.strip().splitlines()[-1]) if proc.stdout.strip() else {}
        print(f"{label} repro {gold['artifact']}: rc={proc.returncode} "
              f"match={verdict.get('match')} cli_s={cli_s:.3f} stdout_sha256={out_sha}")
        if proc.returncode != 0 or not verdict.get("match") \
                or out_sha != gold["repro_stdout_sha256"]:
            print(proc.stderr[-3000:], file=sys.stderr)
            raise SystemExit(f"{label}: the CLI replay disagrees with JAX's")
        return cli_s

    return finish


def run_triage_wedge(sk, goldens, here: str, card: str) -> dict:
    """Phase 11b: the sweep under the seeded wedge, then the culprit case
    shrunk with 8-lane dispatches, saved and replayed."""
    from tpu_paxos_torch.harness import shrink as shr
    from tpu_paxos_torch.harness import stress

    gold = goldens["triage_wedge"]
    sw = gold["sweep"]
    mix = [m for m in stress.MIXES if m[0] == sw["mix"]]
    with _armed({"TPU_PAXOS_SEEDED_WEDGE": sw["wedge"]}), tempfile.TemporaryDirectory() as tmp:
        s = stress.sweep(n_seeds=sw["n_seeds"], mixes=mix, verbose=False, triage_dir=tmp,
                         device=DEV)
    less = {k: v for k, v in s.items() if k != "seconds"}
    print(f"triage sweep ({sw['mix']} x {sw['n_seeds']} seeds, TPU_PAXOS_SEEDED_WEDGE="
          f"{sw['wedge']}): seconds={s['seconds']} summary={json.dumps(less, sort_keys=True)}")
    if less != sw["summary"]:
        raise SystemExit("the seeded-wedge sweep disagrees with its JAX golden")
    # the golden's takeover case, a seeded wedge, is held by phase 17b's
    # recall: a takeover wedge shrunk on the same 8-lane evaluator
    spec = gold["cases"]["culprit"]
    label = "triage [culprit]"
    case = _case_from_spec(shr, spec)
    with tempfile.TemporaryDirectory() as tmp, _armed(spec["env"]):
        got = _shrink_on_card(sk, shr, case, spec["max_evals"], True)
        _print_shrink(label, got, card)
        _hold_shrink(shr, got, spec, label)
        if min(got["launches"].values()) < 1 or any(
            shr.SHRINK_BATCH_LANES not in v for v in got["lanes"].values()
        ):
            raise SystemExit(f"{label}: a simkern kernel did not launch on "
                             f"{shr.SHRINK_BATCH_LANES}-lane operands")
        saved = _save(shr, got, spec, tmp, label)
        cli_s = _replay(here, saved["path"], spec, spec["env"], label)()
        os.remove(saved["path"])
        out = {"culprit": dict(saved, cli_s=cli_s, wall_s=got["wall_s"],
                               launches=got["launches"], dispatches=got["dispatches"],
                               evals=got["evals"])}
        stats = {}
        with check_launches(sk, TRIAGE_REPS, stats, lanes=shr.SHRINK_BATCH_LANES):
            again = shr.shrink_case(case, max_evals=spec["max_evals"], device=DEV)
        if shr._cfg_to_dict(again[0].cfg) != spec["final_cfg"]:
            raise SystemExit(f"{label}: the checked shrink disagrees with its golden")
        out["checked"] = _summarize_checked(
            f"{label} {shr.SHRINK_BATCH_LANES}-lane shrink operands", stats)
    return out


def run_triage_full(sk, goldens, here: str, card: str, keep_dir: str) -> dict:
    """Phase 11c: the shrink and artifact at bench_sim's width; the
    artifact stays in ``keep_dir`` for its replay and phase 12's trace."""
    import numpy as np

    from tpu_paxos_torch.core import sim
    from tpu_paxos_torch.harness import shrink as shr

    gold = goldens["triage_full"]
    cfg = _golden_cfg(gold["config"])
    wl = sim.default_workload(cfg)
    case = shr.ReproCase(cfg=cfg, workload=wl, gates=None,
                         chains=[np.zeros(0, np.int32)] * len(wl),
                         extra_checks=dict(gold["extra_checks"]))
    label = f"triage [full, I={cfg.n_instances}]"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with _armed({}):
        got = _shrink_on_card(sk, shr, case, gold["max_evals"], gold["batch"])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        _print_shrink(label, got, card)
        print(f"{label} peak device memory {peak_gb:.2f} GB (one-lane runtime runs)")
        _hold_shrink(shr, got, gold, label)
        if min(got["launches"].values()) < 1:
            raise SystemExit(f"{label}: a simkern kernel was never launched")
        rec = _save(shr, got, gold, keep_dir, label)
    torch.cuda.empty_cache()
    return dict(rec, label=label, wall_s=got["wall_s"], launches=got["launches"],
                peak_gb=peak_gb)


def _dict_diff(got: dict, want: dict) -> str:
    """The keys where two summary dicts differ, with both values."""
    keys = sorted(set(got) | set(want))
    return "; ".join(f"{k}: port {got.get(k)!r} JAX {want.get(k)!r}"
                     for k in keys if got.get(k) != want.get(k))[:4000]


def _telemetry_sha(d: dict) -> str:
    return hashlib.sha256(json.dumps(d, sort_keys=True, separators=(",", ":")).encode()).hexdigest()


def _same_syncs(turns, what: str) -> None:
    """The fewest syncs a round of the armed turns must equal the plain
    turns': a first use of the pinned-memory pool in a turn can add one
    sync to its count, which is no host read of a round."""
    least = {armed: min(r["syncs_per_round"] for r in turns if r["armed"] == armed)
             for armed in (False, True)}
    if least[True] != least[False]:
        raise SystemExit(f"{what} makes other host syncs a round than the plain one: {least}")


def _loop_run(cfg, armed: bool, window_rounds: int) -> dict:
    """One full-width run's round loop alone, plain or armed: wall
    seconds, round calls and host syncs (set-up and results excluded)."""
    import numpy as np

    from tpu_paxos_torch.core import sim
    from tpu_paxos_torch.telemetry import recorder as telem

    wl = sim.default_workload(cfg)
    pend, gate, tail, c = sim.prepare_queues(cfg, wl)
    root = sim.prng.root_key(cfg.seed)
    state = sim.lanes_view(sim.init_state(cfg, pend, gate, tail, root, device=DEV))
    rf = sim.build_engine(cfg, c, device=DEV, telemetry=armed,
                          window_rounds=window_rounds if armed else 0)
    kw = {}
    if armed:
        kw["tele"] = (
            telem.init_telemetry(cfg.n_instances, len(cfg.proposers), cfg.n_nodes, device=DEV),
            telem.init_windows(cfg.n_nodes, device=DEV),
        )
    roots = np.asarray([root], np.uint64)
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    syncs = count_syncs(lambda: out.setdefault(
        "r", sim.run_lanes(rf, roots, state, [cfg.round_budget], **kw)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    calls = out.pop("r")[-1]
    return {"wall_s": wall, "calls": calls, "syncs": syncs, "ms_per_round": wall / calls * 1e3,
            "syncs_per_round": syncs / calls}


def run_telemetry_single(sk, goldens, card: str) -> dict:
    """Phases 12a-b: the armed engine at full width."""
    from tpu_paxos_torch.core import sim
    from tpu_paxos_torch.replay.decision_log import decision_log, sha256
    from tpu_paxos_torch.telemetry import recorder as telem

    tg = goldens["telemetry"]
    ww = tg["window_rounds"]
    out = {"launches": {}}
    # bench_sim runs twice: counted, then with every launch held against
    # its plain version (whose comparison launches must not count)
    jobs = [(key, False) for key in sorted(tg["runs"])] + [("bench_sim", True)]
    for key, checked in jobs:
        run = tg["runs"][key]
        gold = goldens[key]
        cfg = _golden_cfg(gold["config"])
        stats = {}
        check = check_launches(sk, FULL_REPS, stats) if checked else contextlib.nullcontext()
        torch.cuda.synchronize()
        sk.reset_counts()
        t0 = time.perf_counter()
        with check:
            res, summ, wsum = sim.run_with_telemetry(
                cfg, window_rounds=ww, region_map=run["region_map"], device=DEV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(sk.LAUNCHES)
        d = telem.summary_to_dict(summ, wsum, ww, tuple(run["region_names"]))
        sha = sha256(decision_log(res.chosen_vid, res.chosen_ballot, gold["stride"], cfg.n_instances))
        same = d == run["summary"]
        what = "kernel checks included" if checked else \
            f"launches={json.dumps(launches, sort_keys=True)}"
        print(f"armed {key} (run_with_telemetry, I={cfg.n_instances}, window_rounds {ww}): "
              f"rounds={res.rounds} wall_s={wall:.3f} {what} decision_log_sha256={sha} "
              f"summary_equal={same} decided={d['decided']} offered_total={d['offered_total']} "
              f"latency_p99={d['latency_p99']} region_pairs={d['region_pairs']['n_regions']} | {card}")
        if sha != gold["decision_log_sha256"] or sha != run["decision_log_sha256"]:
            raise SystemExit(f"armed {key}: the decision log differs from the plain golden")
        if not same:
            raise SystemExit(f"armed {key}: the summary differs from JAX's: "
                             f"{_dict_diff(d, run['summary'])}")
        if checked:
            out["checked"] = _summarize_checked(f"armed {key} operands", stats)
        elif min(launches.values()) < 1:
            raise SystemExit(f"armed {key}: a simkern kernel was never launched")
        else:
            out["launches"][key] = launches
        del res, summ, wsum
        torch.cuda.empty_cache()
    cfg = _golden_cfg(goldens["bench_sim"]["config"])
    turns = []
    for armed in (False, True, True, False):
        r = dict(_loop_run(cfg, armed, ww), armed=armed)
        turns.append(r)
        print(f"bench_sim round loop {'armed' if armed else 'plain'}: {r['calls']} round calls, "
              f"wall_s={r['wall_s']:.3f} ms_per_round={r['ms_per_round']:.3f} "
              f"syncs={r['syncs']} syncs_per_round={r['syncs_per_round']:.2f} | {card}")
        torch.cuda.empty_cache()
    _same_syncs(turns, "the armed round")
    out["loop"] = turns
    return out


def run_telemetry_fleet(sk, goldens, card: str) -> dict:
    """Phase 12c: the fleet's headline cycle, plain and armed in turns."""
    import numpy as np

    from tpu_paxos_torch import config as cfgm
    from tpu_paxos_torch.core import wan
    from tpu_paxos_torch.fleet import runner as frun
    from tpu_paxos_torch.fleet import search
    from tpu_paxos_torch.harness import stress

    gold = goldens["fleet"]
    tg = goldens["telemetry"]["fleet"]
    c = gold["config"]
    n = c["lanes"]
    wl, gates, _ = stress._workload(2, np.random.default_rng(0))
    cfg = cfgm.SimConfig(
        n_nodes=c["n_nodes"], n_instances=c["n_instances"], proposers=tuple(c["proposers"]),
        seed=c["seed"], max_rounds=c["max_rounds"], faults=cfgm.FaultConfig(**c["faults"]),
    )
    rng = np.random.default_rng(1)
    scheds = [search.sample_schedule(rng, 5, 4, 96) for _ in range(n)]
    gc = gold[tg["cycle"]]
    mixes = gc["knob_mixes"]
    knobs = [cfgm.FaultConfig(**mixes[i % len(mixes)]) for i in range(n)]
    seeds = [gc["first_seed"] + i for i in range(n)]
    maps = [wan.node_regions(wan.WAN3, 5).tolist(), wan.node_regions(wan.WAN5, 5).tolist(), None]
    regions = [maps[i % len(maps)] for i in range(n)]
    runners = {False: frun.FleetRunner(cfg, wl, gates, device=DEV),
               True: frun.FleetRunner(cfg, wl, gates, device=DEV, telemetry=True)}
    turns = []
    for armed in (False, True, True, False):
        kw = {"regions": regions} if armed else {}
        it = {}
        torch.cuda.synchronize()
        sk.reset_counts()
        with lane_counts(sk) as shapes:
            syncs = count_syncs(lambda: it.setdefault(
                "rep", runners[armed].run(seeds, scheds, knobs=knobs, **kw)))
        rep = it.pop("rep")
        launches = dict(sk.LAUNCHES)
        r = {"armed": armed, "lanes_per_sec": rep.lanes_per_sec, "seconds": rep.seconds,
             "iterations": rep.iterations, "ms_per_round": rep.seconds / rep.iterations * 1e3,
             "syncs_per_round": syncs / rep.iterations, "launches": launches}
        shas = [_lane_sha(rep, i, gold["stride"]) for i in range(n)]
        off = [i for i in range(n) if shas[i] != gc["decision_log_sha256"][i]]
        tele_off = []
        if armed:
            tele_off = [i for i in range(n)
                        if _telemetry_sha(rep.lane_telemetry(i)) != tg["lane_telemetry_sha256"][i]]
            for key, want in tg["lane_telemetry"].items():
                if rep.lane_telemetry(int(key)) != want:
                    print(f"armed fleet lane {key}: {_dict_diff(rep.lane_telemetry(int(key)), want)}",
                          file=sys.stderr)
        lanes_ok = all(x == [n] * len(x) for x in shapes.values())
        print(f"fleet [{tg['cycle']}] {n} lanes {'armed' if armed else 'plain'}: "
              f"lanes_per_sec={r['lanes_per_sec']:.2f} seconds={r['seconds']:.3f} "
              f"iterations={r['iterations']} ms_per_round={r['ms_per_round']:.3f} "
              f"syncs_per_round={r['syncs_per_round']:.2f} launches={json.dumps(launches, sort_keys=True)} "
              f"lanes_per_launch_ok={lanes_ok} decision_log_off={off} lane_telemetry_off={tele_off} "
              f"| {card}")
        if off or tele_off or not rep.verdict.ok.all():
            raise SystemExit(f"fleet [{tg['cycle']}] {'armed' if armed else 'plain'} disagrees "
                             "with its JAX goldens")
        if min(launches.values()) < 1 or not lanes_ok:
            raise SystemExit(f"fleet: a simkern kernel did not launch on {n}-lane operands")
        turns.append(r)
        del rep
    _same_syncs(turns, "the armed fleet")
    return {"turns": turns, "launches": turns[1]["launches"]}


def run_trace_cli(goldens, here: str, paths: dict, card: str) -> dict:
    """Phase 12d: ``python -m tpu_paxos_torch trace`` on the artifacts of
    ``paths`` (golden name -> path), the processes at once."""
    tg = goldens["telemetry"]["trace"]
    before = {name: _file_sha256(path) for name, path in paths.items()}
    t0 = time.perf_counter()
    procs = {
        name: subprocess.Popen(
            [sys.executable, "-m", "tpu_paxos_torch", "trace", os.path.basename(path), "--stdout",
             "--device", DEV],
            cwd=os.path.dirname(path), env=_port_env(here, tg[name]["env"]),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for name, path in sorted(paths.items())
    }
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        wall = time.perf_counter() - t0
        g = tg[name]
        sha = hashlib.sha256(stdout.encode()).hexdigest()
        after = _file_sha256(paths[name])
        print(f"trace {name} (python -m tpu_paxos_torch trace --stdout): rc={proc.returncode} "
              f"done_after_s={wall:.3f} stdout_bytes={len(stdout.encode())} stdout_sha256={sha} "
              f"artifact_unchanged={before[name] == after} | {card}")
        if proc.returncode != 0 or sha != g["stdout_sha256"] or before[name] != after \
                or after != g["artifact_sha256"]:
            print(stderr[-3000:], file=sys.stderr)
            for p in procs.values():
                p.kill()
            raise SystemExit(f"trace {name} disagrees with JAX's")
        out[name] = wall
    return out

SEARCH_TIMING = ("seconds", "lanes_per_sec")
STRESS_TIMING = ("seconds", "lanes_per_sec", "compiles_per_mix")
ENVELOPE_REPS = 3  # launches timed on each snapshot of the checked padded dispatch


def _less_timing(summary: dict, keys) -> dict:
    """A search or sweep summary less its wall-clock keys, each wedge's or
    failure's ``shrink_seconds`` dropped and artifact paths cut to their
    basename, as the goldens hold them."""
    out = {k: v for k, v in summary.items() if k not in keys}
    for key in ("wedges", "failures"):
        if key in out:
            out[key] = [{k: (os.path.basename(v) if k == "artifact" else v)
                         for k, v in item.items() if k != "shrink_seconds"} for item in out[key]]
    return out


def start_fleet_quick(goldens, here: str, tmp: str):
    """Phase 13a's search, started as a subprocess writing into ``tmp``;
    returns the process and its start time."""
    gold = goldens["search"]["fleet_quick"]
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_paxos_torch", "fleet", *gold["args"], "--triage-dir", tmp,
         "--quiet", "--device", DEV],
        cwd=here, env=_port_env(here), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    return proc, time.perf_counter()


def run_fleet_quick(goldens, here: str, card: str, started, tmp: str) -> dict:
    """Phase 13a: ``make fleet-quick``'s search (``started`` by
    :func:`start_fleet_quick`), its wedge artifact and its CLI replay."""
    gold = goldens["search"]["fleet_quick"]
    proc, t0 = started
    stdout, stderr = proc.communicate(timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or not stdout.strip():
        print(stderr[-3000:], file=sys.stderr)
        raise SystemExit(f"fleet-quick exited {proc.returncode}")
    summary = json.loads(stdout.strip().splitlines()[-1])
    path = os.path.join(tmp, gold["artifact"])
    sha = _file_sha256(path)
    rproc, cli_s = _repro_cli(here, path, {})
    out_sha = hashlib.sha256(rproc.stdout.encode()).hexdigest()
    less = _less_timing(summary, SEARCH_TIMING)
    w = summary["wedges"][0] if summary["wedges"] else {}
    print(f"fleet-quick (python -m tpu_paxos_torch fleet {' '.join(gold['args'])}): "
          f"rc={proc.returncode} done_after_s={wall:.3f} search_seconds={summary['seconds']} "
          f"lanes_per_sec={summary['lanes_per_sec']} shrink_seconds={w.get('shrink_seconds')} "
          f"wedges={summary['wedges_found']} summary_equal={less == gold['summary']} "
          f"artifact_sha256={sha}; repro rc={rproc.returncode} cli_s={cli_s:.3f} "
          f"stdout_sha256={out_sha} | {card}")
    if less != gold["summary"]:
        raise SystemExit(f"fleet-quick disagrees with its JAX golden: "
                         f"{_dict_diff(less, gold['summary'])}")
    if sha != gold["artifact_sha256"]:
        raise SystemExit("fleet-quick's wedge artifact differs from JAX's")
    if rproc.returncode != 0 or out_sha != gold["repro_stdout_sha256"]:
        print(rproc.stderr[-3000:], file=sys.stderr)
        raise SystemExit("fleet-quick's artifact replay disagrees with JAX's")
    return {"done_after_s": wall, "seconds": summary["seconds"],
            "lanes_per_sec": summary["lanes_per_sec"], "shrink_seconds": w.get("shrink_seconds")}


def run_search_wide(sk, goldens, card: str) -> dict:
    """Phase 13b: the gray/WAN search at the card's default lane count,
    through the CLI's entry point in this process."""
    from tpu_paxos_torch.fleet import runner as frun
    from tpu_paxos_torch.fleet import search

    gold = goldens["search"]["search_wide"]
    n = frun.default_lane_count(DEV)
    if n != gold["lanes"]:
        raise SystemExit(f"the card's default lane count is {n}, the golden's {gold['lanes']}")
    buf = io.StringIO()
    torch.cuda.synchronize()
    sk.reset_counts()
    with lane_counts(sk) as shapes, dispatch_log() as disp, contextlib.redirect_stdout(buf):
        syncs = count_syncs(lambda: search.main([*gold["args"], "--quiet", "--device", DEV]))
    launches = dict(sk.LAUNCHES)
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    rounds = sum(d[1] for d in disp)
    secs = sum(d[2] for d in disp)
    less = _less_timing(summary, SEARCH_TIMING)
    lanes_ok = all(x == [n] * len(x) for x in shapes.values())
    print(f"search --lanes {n} {' '.join(gold['args'])}: lanes_per_sec={summary['lanes_per_sec']} "
          f"seconds={summary['seconds']} dispatches={len(disp)} round_calls={rounds} "
          f"dispatch_s={secs:.3f} ms_per_round={secs / max(rounds, 1) * 1e3:.3f} "
          f"syncs_per_round={syncs / max(rounds, 1):.2f} "
          f"launches={json.dumps(launches, sort_keys=True)} lanes_per_launch_ok={lanes_ok} "
          f"summary_equal={less == gold['summary']} | {card}")
    if less != gold["summary"]:
        raise SystemExit(f"the wide search disagrees with its JAX golden: "
                         f"{_dict_diff(less, gold['summary'])}")
    if min(launches.values()) < 1 or not lanes_ok:
        raise SystemExit(f"the wide search: a simkern kernel did not launch on {n}-lane operands")
    return {"launches": launches, "lanes_per_sec": summary["lanes_per_sec"],
            "ms_per_round": secs / max(rounds, 1) * 1e3, "syncs_per_round": syncs / max(rounds, 1),
            "round_calls": rounds}


def run_stress_fleet(goldens, card: str) -> dict:
    """Phase 13c: what ``stress --fleet`` runs, in this process: the fleet
    sweep of the episode and WAN mixes at the golden's seeds (8-lane
    dispatches) and the host-loop sweep of the i.i.d. mixes at its
    ``host_seeds`` (one seed a mix: the host loop's one-lane runs cost
    2.7-3.1 s each on the card)."""
    from tpu_paxos_torch.fleet import envelope
    from tpu_paxos_torch.harness import stress

    gold = goldens["stress_fleet"]
    envelope.clear_cache()  # runners_built then counts this sweep's builds
    host_mixes = [m for m in stress.MIXES if "schedule" not in m[1]]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        host = stress.sweep(gold["host_seeds"], 0, verbose=False, triage_dir=tmp,
                            mixes=host_mixes, device=DEV)
        host_s = time.perf_counter() - t0
        fleet = stress.sweep_fleet(gold["seeds"], 0, verbose=False, triage_dir=tmp, device=DEV)
        wall = time.perf_counter() - t0
        left = sorted(os.listdir(tmp))
    hl, fl = _less_timing(host, STRESS_TIMING), _less_timing(fleet, STRESS_TIMING)
    print(f"stress --fleet (fleet sweep at {gold['seeds']} seeds, host loop at "
          f"{gold['host_seeds']}): wall_s={wall:.3f} host_s={host_s:.3f} "
          f"host_seconds={host['seconds']} fleet_seconds={fleet['seconds']} "
          f"fleet_lanes_per_sec={fleet['lanes_per_sec']} "
          f"runners_built={json.dumps(fleet['compiles_per_mix'], sort_keys=True)} "
          f"host_equal={hl == gold['host']} fleet_equal={fl == gold['fleet']} artifacts={left} "
          f"| {card}")
    if hl != gold["host"]:
        raise SystemExit(f"stress --fleet's host sweep disagrees with JAX's: "
                         f"{_dict_diff(hl, gold['host'])}")
    if fl != gold["fleet"]:
        for mix, want in gold["fleet"]["telemetry"].items():
            got = fl["telemetry"].get(mix, {})
            if got != want:
                print(f"stress --fleet telemetry [{mix}]: {_dict_diff(got, want)}", file=sys.stderr)
        raise SystemExit(f"stress --fleet's fleet sweep disagrees with JAX's: "
                         f"{_dict_diff(fl, gold['fleet'])}")
    return {"wall_s": wall, "host_s": host_s, "host_seconds": host["seconds"],
            "fleet_seconds": fleet["seconds"], "lanes_per_sec": fleet["lanes_per_sec"]}


def run_envelope(sk, goldens, card: str) -> dict:
    """Phase 13d: the geometry-padded envelope at bench.py's configuration."""
    import numpy as np

    from tpu_paxos_torch import config as cfgm
    from tpu_paxos_torch.core import geom
    from tpu_paxos_torch.fleet import envelope

    gold = goldens["envelope"]
    e = gold["config"]
    genv = geom.GeometryEnvelope(tuple((n, tuple(p)) for n, p in e["menu"]))
    tmpl = [np.arange(lo, hi, dtype=np.int32) for lo, hi in e["template"]]
    lanes = e["lanes"]
    seeds = [e["first_seed"] + i for i in range(lanes)]
    bound = (genv.bound_nodes, genv.bound_proposers)

    def cell_args(c):
        n, props = c["n_nodes"], tuple(c["proposers"])
        pc = cfgm.ProtocolConfig(**e["protocols"][c["protocol"]])
        cfg = cfgm.SimConfig(n_nodes=n, n_instances=e["n_instances"], proposers=props, seed=0,
                             max_rounds=e["max_rounds"], faults=cfgm.FaultConfig(max_delay=2),
                             protocol=pc)
        wl = tmpl[: len(props)]
        kw = dict(workloads=[(wl, None)] * lanes,
                  knobs=[cfgm.FaultConfig(**e["rates"][c["rate"]])] * lanes)
        return cfg, wl, kw, dict(geometry=(n, props), protocol=pc)

    def shas(rep):
        return [_lane_sha(rep, i, e["stride"]) for i in range(lanes)]

    envelope.clear_cache()
    before = envelope.cache_misses()
    runners, padded, off = set(), {}, []
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    sk.reset_counts()
    with lane_counts(sk) as shapes:
        for k, c in enumerate(gold["cells"]):
            cfg, wl, kw, gp = cell_args(c)
            runner = envelope.runner_for(cfg, tmpl, geometry=genv, device=DEV)
            runners.add(id(runner))
            rep = runner.run(seeds, [None] * lanes, **kw, **gp)
            padded[k] = shas(rep)
            if (padded[k] != c["decision_log_sha256"] or rep.verdict.rounds.tolist() != c["rounds"]
                    or rep.verdict.ok.tolist() != c["ok"]):
                off.append(k)
    grid_s = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)
    builds = envelope.cache_misses() - before
    lanes_ok = all(x == [lanes] * len(x) for x in shapes.values())
    print(f"envelope grid ({len(gold['cells'])} cells x {lanes} lanes, bound {bound}): "
          f"grid_s={grid_s:.3f} runners={len(runners)} runners_built={builds} "
          f"launches={json.dumps(launches, sort_keys=True)} lanes_per_launch_ok={lanes_ok} "
          f"cells_off_golden={off} | {card}")
    if off:
        raise SystemExit(f"the padded envelope disagrees with its JAX goldens in cells {off}")
    if builds != 1 or len(runners) != 1:
        raise SystemExit(f"the envelope grid built {builds} runners; one must serve it")
    if min(launches.values()) < 1 or not lanes_ok:
        raise SystemExit(f"the envelope: a simkern kernel did not launch on {lanes}-lane operands")
    twins_off = []
    for k, c in enumerate(gold["cells"]):
        cfg, wl, kw, _ = cell_args(c)
        rep = envelope.runner_for(cfg, wl, device=DEV).run(seeds, [None] * lanes, **kw)
        if shas(rep) != padded[k]:
            twins_off.append(k)
    print(f"envelope bound-free twins on the card: cells_off={twins_off}")
    if twins_off:
        raise SystemExit(f"padded lanes differ from their bound-free twins in cells {twins_off}")
    # the padding toll: bench.py's timed cell (first protocol, second rate)
    toll = {}
    for c in gold["cells"]:
        if c["protocol"] != 0 or c["rate"] != 1:
            continue
        cfg, wl, kw, gp = cell_args(c)
        runs = {True: lambda: envelope.runner_for(cfg, tmpl, geometry=genv, device=DEV).run(
                    seeds, [None] * lanes, **kw, **gp),
                False: lambda: envelope.runner_for(cfg, wl, device=DEV).run(
                    seeds, [None] * lanes, **kw)}
        got = {True: [], False: []}
        for pad in (True, False, False, True):
            got[pad].append(runs[pad]().lanes_per_sec)
        n = c["n_nodes"]
        toll[n] = {"padded": got[True], "unpadded": got[False]}
        print(f"envelope padding toll at {n} nodes (turns padded, unpadded, unpadded, padded): "
              f"padded lanes_per_sec={[round(x, 2) for x in got[True]]} unpadded "
              f"{[round(x, 2) for x in got[False]]} ratio="
              f"{sum(got[True]) / sum(got[False]):.3f} | {card}")
    stats = {}
    c = [c for c in gold["cells"] if c["n_nodes"] == bound[0]][0]
    cfg, wl, kw, gp = cell_args(c)
    with check_launches(sk, ENVELOPE_REPS, stats, lanes=lanes):
        rep = envelope.runner_for(cfg, tmpl, geometry=genv, device=DEV).run(
            seeds, [None] * lanes, **kw, **gp)
    if shas(rep) != c["decision_log_sha256"]:
        raise SystemExit("the checked padded dispatch disagrees with its JAX golden")
    checked = _summarize_checked(
        f"envelope (A, P) = {bound} {lanes}-lane operands (7 nodes)", stats)
    envelope.clear_cache()
    torch.cuda.empty_cache()
    return {"launches": launches, "grid_s": grid_s, "toll": toll, "checked": checked}


def _goldens_script(here: str):
    """``scripts/torch_port_goldens.py`` as a module: the membership
    scenarios the JAX goldens were computed on, driven here with the port
    (the script imports the JAX package only inside its JAX functions)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_port_goldens", os.path.join(here, "scripts", "torch_port_goldens.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sha_text(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def _chosen_round_sha(state) -> str:
    import numpy as np

    return hashlib.sha256(np.asarray(state.chosen_round.cpu().numpy(), "<i4").tobytes()).hexdigest()


def _timed(fn):
    """``(result, wall seconds, peak device GB)`` of ``fn()``, synchronized."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9


def _same_member_state(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def run_member_config5(goldens, script, card: str) -> dict:
    """Phase 14a: BASELINE config 5 at its literal size, through both churn
    drivers and through the host driver ``MemberSim``."""
    from tpu_paxos_torch.membership import churn_table as ctm
    from tpu_paxos_torch.membership import engine as meng

    gold = goldens["member"]
    c5 = gold["config5"]["config"]
    eng = meng.ChurnEngine(
        c5["n_nodes"], c5["n_instances"],
        churn=ctm.grow_shrink_schedule(c5["grow_to"], c5["shrink_to"], c5["values_per_step"]),
        max_rounds=c5["max_rounds"], device=DEV,
    )
    eng.run(seed=c5["seeds"][0])  # warm-up: the card's first allocations and launches
    out = {}
    for seed in c5["seeds"]:
        want = gold["config5"]["runs"][str(seed)]
        res = {}
        for driver in ("run", "run_host"):
            r, wall, peak = _timed(lambda: getattr(eng, driver)(seed=seed))
            got = {"rounds": r.rounds, "done": r.done, "injected": r.injected,
                   "decision_log_sha256": _sha_text(r.decision_log()),
                   "chosen_round_sha256": _chosen_round_sha(r.state)}
            it = {}
            syncs = count_syncs(lambda: it.setdefault("r", getattr(eng, driver)(seed=seed)))
            res[driver] = r
            rec = {"wall_s": wall, "rounds": r.rounds, "ms_per_round": wall / r.rounds * 1e3,
                   "syncs_per_round": syncs / r.rounds, "peak_gb": peak}
            out[f"{driver}_{seed}"] = rec
            print(f"member config 5 [{driver} seed {seed}] (7 nodes, I={c5['n_instances']}): "
                  f"wall_s={wall:.3f} rounds={r.rounds} ms_per_round={rec['ms_per_round']:.3f} "
                  f"syncs_per_round={rec['syncs_per_round']:.2f} peak_gb={peak:.3f} "
                  f"golden_off={[k for k in want if got[k] != want[k]]} | {card}")
            if got != want:
                raise SystemExit(f"member config 5 [{driver} seed {seed}] disagrees with its "
                                 f"JAX golden: {_dict_diff(got, want)}")
        if not _same_member_state(res["run"].state, res["run_host"].state):
            raise SystemExit(f"member config 5 seed {seed}: run and run_host end in different states")
    del eng, res
    want = gold["literal"]
    ms, wall, peak = _timed(lambda: script.literal_scenario(meng.MemberSim, c5["n_instances"],
                                                            device=DEV))
    rounds = int(ms.state.t)
    syncs = count_syncs(lambda: script.literal_scenario(meng.MemberSim, c5["n_instances"],
                                                        device=DEV))
    got = {"rounds": rounds, "acceptors": sorted(ms.acceptor_set(0)),
           "decision_log_sha256": _sha_text(ms.decision_log()),
           "chosen_round_sha256": _chosen_round_sha(ms.state)}
    out["literal"] = {"wall_s": wall, "rounds": rounds, "ms_per_round": wall / rounds * 1e3,
                      "syncs_per_round": syncs / rounds, "peak_gb": peak}
    print(f"member config 5 [MemberSim literal scenario] (7 nodes, I={c5['n_instances']}): "
          f"wall_s={wall:.3f} rounds={rounds} ms_per_round={out['literal']['ms_per_round']:.3f} "
          f"syncs_per_round={out['literal']['syncs_per_round']:.2f} peak_gb={peak:.3f} | {card}")
    if got != want:
        raise SystemExit(f"the literal MemberSim scenario disagrees with its JAX golden: "
                         f"{_dict_diff(got, want)}")
    torch.cuda.empty_cache()
    return out


def run_member_cli(goldens, here: str, card: str) -> dict:
    """Phase 14b: the member CLI (the reference member demo workload) with
    record and replay, and a crash-rate line, as subprocesses."""
    gold = goldens["member"]["cli"]
    name = gold["injections"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as rec_dir, tempfile.TemporaryDirectory() as crash_dir:
        def start(args, cwd):
            return subprocess.Popen(
                [sys.executable, "-m", "tpu_paxos_torch", *gold["args"], *args, "--device", DEV],
                cwd=cwd, env=_port_env(here), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)

        procs = {"record": start(["--record-injections", name], rec_dir),
                 "crash": start([f"--crash-rate={gold['crash_rate']}"], crash_dir)}
        outs = {k: p.communicate(timeout=600) for k, p in procs.items()}
        replay = start(["--replay-injections", name], rec_dir)
        outs["replay"] = replay.communicate(timeout=600)
        rcs = {k: p.returncode for k, p in (*procs.items(), ("replay", replay))}
        with open(os.path.join(rec_dir, name)) as f:
            log = f.read()
    wall = time.perf_counter() - t0
    off = [k for k in ("record", "replay", "crash") if outs[k][0] != gold[f"{k}_stdout"]]
    print(f"member CLI ({' '.join(gold['args'])}: record, replay, crash-rate "
          f"{gold['crash_rate']}): wall_s={wall:.1f} rcs={rcs} stdout_off={off} "
          f"injection_log_equal={log == gold['injection_log']} | {card}")
    for k, (so, se) in outs.items():
        if rcs[k] != 0:
            print(se[-3000:], file=sys.stderr)
    if off or any(rcs.values()) or log != gold["injection_log"]:
        raise SystemExit("the member CLI disagrees with the JAX CLI's goldens")
    return {"wall_s": wall}


def run_member_rejoin(goldens, script, card: str) -> dict:
    """Phase 14c: crash, checkpoint, rejoin, record and replay at the
    literal size; a checkpoint restored into the wrong geometry raises."""
    from tpu_paxos_torch import checkpoint
    from tpu_paxos_torch.membership import engine as meng

    gold = goldens["member"]["rejoin"]
    n_inst = goldens["member"]["config5"]["config"]["n_instances"]
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "rejoin.npz")
        ms, wall, peak = _timed(lambda: script.rejoin_scenario(meng.MemberSim, checkpoint, ck,
                                                               n_inst, device=DEV))
        inj = os.path.join(tmp, "rejoin_injections.json")
        ms.save_injections(inj)
        again, replay_wall, _ = _timed(lambda: meng.MemberSim.replay(inj, device=DEV))
        got = {"rounds": int(ms.state.t), "decision_log_sha256": _sha_text(ms.decision_log()),
               "ops": script.rejoin_ops(ms.injections)}
        same = again.decision_log() == ms.decision_log() and _same_member_state(again.state, ms.state)
        wrong = meng._init(7, n_inst // 2, n_inst + 8, DEV)
        try:
            checkpoint.restore(ck, like=wrong)
            refused = ""
        except ValueError as e:
            refused = str(e)
    print(f"member rejoin (7 nodes, I={n_inst}, crash -> checkpoint -> rejoin -> replay): "
          f"wall_s={wall:.3f} replay_wall_s={replay_wall:.3f} rounds={got['rounds']} "
          f"peak_gb={peak:.3f} replay_equal={same} golden_off="
          f"{[k for k in gold if got[k] != gold[k]]} wrong_geometry_refused={'wrong config' in refused} "
          f"| {card}")
    if got != gold or not same:
        raise SystemExit(f"the member rejoin disagrees with its JAX golden or its replay: "
                         f"{_dict_diff(got, gold)}")
    if "wrong config" not in refused:
        raise SystemExit("a member checkpoint restored into the wrong geometry did not raise")
    torch.cuda.empty_cache()
    return {"wall_s": wall, "replay_wall_s": replay_wall, "rounds": got["rounds"]}


def run_member_fleet(goldens, script, card: str) -> dict:
    """Phase 14d: 128 lanes of the member envelope ``evolve --axis member``
    runs, against the JAX golden; then the padded menu 3/5 against the
    bound-free runners."""
    from tpu_paxos_torch.core import geom
    from tpu_paxos_torch.fleet import envelope
    from tpu_paxos_torch.fleet import member_runner as mrun
    from tpu_paxos_torch.fleet import search

    gold = goldens["member"]["fleet"]
    c = gold["config"]
    env = dict(max_episodes=c["max_episodes"], max_rounds=c["max_rounds"], device=DEV)
    lanes = script.member_fleet_lanes(search, c["lanes"], c["n_nodes"], c["rng_seed"],
                                      c["horizon"], c["max_episodes"])
    if script.genomes_sha256(*lanes) != gold["genomes_sha256"]:
        raise SystemExit("the member fleet's drawn genomes differ from the golden's")
    runner = envelope.member_runner_for(c["n_nodes"], c["n_instances"], **env)
    runner.run(*lanes)  # warm-up
    rep = runner.run(*lanes)
    v = rep.verdict
    bad = [f for f in v._fields if [x.item() for x in getattr(v, f)] != gold[f]]
    shas = [_sha_text(rep.lane_log(i)) for i in range(rep.n_lanes)]
    off = [i for i in range(rep.n_lanes) if shas[i] != gold["decision_log_sha256"][i]]
    it = {}
    syncs = count_syncs(lambda: it.setdefault("rep", runner.run(*lanes)))
    rec = {"lanes_per_sec": rep.lanes_per_sec, "seconds": rep.seconds,
           "iterations": rep.iterations, "ms_per_round": rep.seconds / rep.iterations * 1e3,
           "syncs_per_round": syncs / it["rep"].iterations}
    print(f"member fleet ({c['lanes']} lanes, {c['n_nodes']} nodes, I={c['n_instances']}, "
          f"{c['max_rounds']} rounds): lanes_per_sec={rep.lanes_per_sec:.2f} "
          f"seconds={rep.seconds:.3f} iterations={rep.iterations} "
          f"ms_per_round={rec['ms_per_round']:.3f} syncs_per_round={rec['syncs_per_round']:.2f} "
          f"ok={int(v.ok.sum())}/{rep.n_lanes} verdict_fields_off={bad} decision_log_off={off} "
          f"| {card}")
    if bad or off:
        raise SystemExit("the member fleet disagrees with its JAX golden")
    menu = geom.GeometryEnvelope(((3, (0,)), (5, (0,))))
    padded = mrun.MemberFleetRunner(5, c["n_instances"], geometry=menu, **env)
    twins = {}
    for n in (3, 5):
        lanes_n = lanes if n == c["n_nodes"] else script.member_fleet_lanes(
            search, c["lanes"], n, c["rng_seed"] + 1, c["horizon"], c["max_episodes"])
        prep = padded.run(*lanes_n, n_nodes=n)
        free = rep if n == c["n_nodes"] else mrun.MemberFleetRunner(
            n, c["n_instances"], **env).run(*lanes_n)
        diff = [i for i in range(prep.n_lanes) if prep.lane_log(i) != free.lane_log(i)
                or any(getattr(prep.verdict, f)[i] != getattr(free.verdict, f)[i]
                       for f in v._fields)]
        twins[n] = {"lanes_per_sec": prep.lanes_per_sec, "differ": diff}
        print(f"member fleet padded (menu 3/5) at {n} true nodes vs bound-free: "
              f"lanes_per_sec={prep.lanes_per_sec:.2f} ok={int(prep.verdict.ok.sum())}/"
              f"{prep.n_lanes} lanes_off={diff}")
        if diff:
            raise SystemExit(f"padded member lanes differ from their bound-free twins at {n} nodes")
    envelope.clear_cache()
    return {**rec, "padded": twins}


def run_member(goldens, here: str, card: str) -> dict:
    """Phase 14: membership on the card (none of the three kernels runs on
    this path: the launch counts are zeroed before and printed after)."""
    from tpu_paxos_torch.core import fastwin as fw
    from tpu_paxos_torch.core import simkern as sk

    script = _goldens_script(here)
    t14 = time.perf_counter()
    sk.reset_counts()
    fw.reset_counts()
    out = {"config5": run_member_config5(goldens, script, card)}
    out["cli"] = run_member_cli(goldens, here, card)
    out["rejoin"] = run_member_rejoin(goldens, script, card)
    out["fleet"] = run_member_fleet(goldens, script, card)
    launches = {**sk.LAUNCHES, **fw.LAUNCHES}
    print(f"phase 14 (membership) took {time.perf_counter() - t14:.1f} s; kernel launches on "
          f"the membership path: {json.dumps(launches, sort_keys=True)}")
    return out


SERVE_CHECK = 16  # launches of each kernel held against the plain version in 15a and 15c


def start_serve_clis(gold, here: str):
    """Phase 15d's four CLI processes, started together, each read by a
    thread that notes when it ended."""
    import threading

    t0 = time.perf_counter()
    procs, ended = {}, {}

    def reap(key, proc):
        ended[key] = (*proc.communicate(timeout=900), time.perf_counter() - t0)

    threads = []
    for args in gold["config"]["cli"] + gold["config"]["trace"]:
        key = " ".join(args)
        procs[key] = subprocess.Popen(
            [sys.executable, "-m", "tpu_paxos_torch", *args, "--device", DEV],
            cwd=here, env=_port_env(here), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        threads.append(threading.Thread(target=reap, args=(key, procs[key]), daemon=True))
        threads[-1].start()
    return procs, threads, ended


def finish_serve_clis(gold, script, started, card: str) -> dict:
    """Phase 15d: each CLI's stdout against the JAX CLI's."""
    procs, threads, ended = started
    for th in threads:
        th.join()
    out = {}
    for key, proc in procs.items():
        stdout, stderr, wall = ended[key]
        if key in gold["cli"]:
            want = gold["cli"][key]
            got = script.less_wall(json.loads(stdout.strip().splitlines()[-1]))
            ok = proc.returncode == want["rc"] and got == want["summary"]
            detail = f"summary_equal={got == want['summary']}"
        else:
            sha = hashlib.sha256(stdout.encode()).hexdigest()
            ok = proc.returncode == 0 and sha == gold["trace"][key]["stdout_sha256"]
            detail = f"stdout_bytes={len(stdout.encode())} stdout_sha256={sha}"
        print(f"serve CLI (python -m tpu_paxos_torch {key}): rc={proc.returncode} "
              f"wall_s={wall:.3f} {detail} | {card}")
        if not ok:
            print(stderr[-3000:], file=sys.stderr)
            for p in procs.values():
                p.kill()
            raise SystemExit(f"'{key}' disagrees with the JAX CLI's")
        out[key] = wall
    return out


def _serve_timed(fn):
    """``(result, wall s, syncs, peak GB)`` of ``fn()`` on the card, its
    syncs counted in the timed run itself (about 10 us a warning)."""
    it = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    syncs = count_syncs(lambda: it.setdefault("r", fn()))
    torch.cuda.synchronize()
    return it["r"], time.perf_counter() - t0, syncs, torch.cuda.max_memory_allocated() / 1e9


def _serve_line(label: str, rep, wall, syncs, peak, launches, card, lanes: int = 1) -> dict:
    calls = rep.dispatches * rep.windows_per_dispatch * rep.rounds_per_window
    rate = (f"lanes_per_sec={lanes / wall:.2f} values_per_sec={rep.values_per_sec:.1f}"
            if lanes > 1 else f"values_per_sec={rep.values_per_sec:.1f}")
    print(f"{label}: wall_s={wall:.3f} rounds={rep.rounds} dispatches={rep.dispatches} "
          f"round_calls={calls} ms_per_round={wall / calls * 1e3:.3f} "
          f"syncs_per_round={syncs / calls:.2f} {rate} peak_gb={peak:.3f} "
          f"launches={json.dumps(launches, sort_keys=True)} | {card}")
    return {"wall_s": wall, "round_calls": calls, "ms_per_round": wall / calls * 1e3,
            "syncs_per_round": syncs / calls, "values_per_sec": rep.values_per_sec,
            "peak_gb": peak, "launches": launches}


def run_serve_full(sk, script, m, gold, card: str) -> dict:
    """Phase 15a: the 2**16-value stream on 2**17 instances."""
    import numpy as np

    from tpu_paxos_torch.serve import driver as drv
    from tpu_paxos_torch.utils import prng

    sk.reset_counts()
    with lane_counts(sk) as shapes:
        rep, wall, syncs, peak = _serve_timed(lambda: script.serve_full_run(m, device=DEV))
    launches = dict(sk.LAUNCHES)
    rec = script.serve_report_record(m, rep)
    out = _serve_line(f"serve_full (I={rep.cfg.n_instances}, {rep.n_values} values)", rep, wall,
                      syncs, peak, launches, card)
    lanes_ok = all(x == [1] * len(x) for x in shapes.values())
    if rec != gold["full"]:
        raise SystemExit(f"serve_full disagrees with its JAX golden: {_dict_diff(rec, gold['full'])}")
    if min(launches.values()) < 1 or not lanes_ok:
        raise SystemExit("serve_full: a simkern kernel did not launch on one-lane operands")
    # the sample: the first two dispatches again, the first launches held
    # against the plain version on their own operands
    c = gold["config"]
    cfg = rep.cfg
    streams, arrs = script.serve_stream(m, c["full"]["n_values"], c["full"]["rate_milli"])
    plan = m.arrv.ArrivalPlan(streams, arrs, c["rounds_per_window"])
    k, s = rep.admit_width, c["windows_per_dispatch"]
    vb = drv.vid_bound_of(streams)
    root = prng.root_key(cfg.seed)
    ss, qc = drv.init_serve_state(cfg, streams, vb, root, window_rounds=c["window_rounds"],
                                  device=DEV)
    fn = drv.window_for(cfg, qc, vb, c["rounds_per_window"], window_rounds=c["window_rounds"],
                        device=DEV)
    stats = {}
    with check_launches(sk, SNAP_REPS, stats, limit=SERVE_CHECK):
        for d in range(2):
            blocks = [plan.block(d * s + i, k) for i in range(s)]
            ss = fn(ss, root, np.stack([b[0] for b in blocks]), np.stack([b[1] for b in blocks]))[0]
    out["checked"] = _summarize_checked("serve_full one-lane operands (first 2 dispatches)", stats)
    del ss, rep
    torch.cuda.empty_cache()
    return out


def run_serve_twins(script, m, gold, card: str) -> dict:
    """Phase 15b: the dispatch-granularity twins and the load sweep."""
    width = script.serve_twins_width(m)
    if width != gold["twins_admit_width"]:
        raise SystemExit(f"serve twins: admit width {width}, JAX's {gold['twins_admit_width']}")
    out = {}
    for mode in script.SERVE_TWINS:
        rep, wall, syncs, peak = _serve_timed(
            lambda mode=mode: script.serve_twin_run(m, mode, width, device=DEV))
        rec = script.serve_report_record(m, rep)
        out[mode] = _serve_line(f"serve_twins_4096 [{mode}] (S={rep.windows_per_dispatch})", rep,
                                wall, syncs, peak, {}, card)
        if rec != gold["twins"][mode]:
            raise SystemExit(f"serve twin [{mode}] disagrees with its JAX golden: "
                             f"{_dict_diff(rec, gold['twins'][mode])}")
    t0 = time.perf_counter()
    sweep = script.serve_sweep(m, width, device=DEV)
    wall = time.perf_counter() - t0
    print(f"serve sweep_load {gold['config']['twins']['sweep_rates']}: wall_s={wall:.3f} "
          f"knee={json.dumps(sweep['knee'], sort_keys=True)} equal={sweep == gold['sweep']} | {card}")
    if sweep != gold["sweep"]:
        raise SystemExit(f"sweep_load disagrees with its JAX golden: {_dict_diff(sweep, gold['sweep'])}")
    out["sweep_s"] = wall
    return out


def run_serve_fleet(sk, script, m, gold, card: str) -> dict:
    """Phase 15c: the 256-lane serve fleet at two rates, its kernel
    sample and the zero-load anchor."""
    width = script.serve_fleet_width(m)
    lanes = gold["config"]["fleet"]["lanes"]
    if width != gold["fleet_admit_width"]:
        raise SystemExit(f"serve fleet: admit width {width}, JAX's {gold['fleet_admit_width']}")
    out = {"launches": {"store_accepts": 0, "accum_acks": 0}}
    stats = {}
    last = gold["config"]["fleet"]["rates"][-1]
    for rate in gold["config"]["fleet"]["rates"]:
        sk.reset_counts()
        # the last rate's run is the sample: its first launches' operands
        # are copied in the run and held against the plain version after it
        held = (check_launches(sk, SNAP_REPS, stats, lanes=lanes, limit=SERVE_CHECK, defer=True)
                if rate == last else contextlib.nullcontext())
        with held, lane_counts(sk) as shapes:
            rep, wall, syncs, peak = _serve_timed(
                lambda rate=rate: script.serve_fleet_run(m, rate, width, device=DEV))
        launches = dict(sk.LAUNCHES)
        rec = script.serve_fleet_record(m, rep)
        out[str(rate)] = _serve_line(f"serve_fleet_{lanes} @ {rate} milli (I={rep.cfg.n_instances})",
                                     rep, wall, syncs, peak, launches, card, lanes=lanes)
        want = gold["fleet"][str(rate)]
        print(f"serve_fleet_{lanes} @ {rate}: flagged={len(rec['flagged'])} "
              f"lanes_off={[i for i in range(lanes) if rec['decision_log_sha256'][i] != want['decision_log_sha256'][i]]}")
        if rec != want:
            raise SystemExit(f"serve fleet @ {rate} disagrees with its JAX golden: "
                             f"{_dict_diff(rec, want)}")
        if min(launches.values()) < 1 or not all(x == [lanes] * len(x) for x in shapes.values()):
            raise SystemExit(f"serve fleet: a simkern kernel did not launch on {lanes}-lane operands")
        for key in out["launches"]:
            out["launches"][key] += launches[key]
        del rep
    out["checked"] = _summarize_checked(f"serve_fleet_{lanes} {lanes}-lane operands", stats)
    zl = script.serve_zero_load(m, device=DEV)
    print(f"serve fleet 1-lane zero-load vs closed-loop sim.run: fleet_sha={zl['fleet']} "
          f"closed_sha={zl['closed']} equal={zl['fleet'] == zl['closed']} "
          f"golden_equal={zl == gold['zero_load']}")
    if zl != gold["zero_load"] or zl["fleet"] != zl["closed"]:
        raise SystemExit("the 1-lane zero-load serve fleet differs from the closed-loop run")
    torch.cuda.empty_cache()
    return out


def run_serve(goldens, here: str, card: str) -> dict:
    """Phase 15: open-loop serving on the card."""
    from tpu_paxos_torch.core import simkern as sk

    gold = goldens["serve"]
    script = _goldens_script(here)
    m = script.serve_modules(port=True)
    t15 = time.perf_counter()
    clis = start_serve_clis(gold, here)
    out = {"full": run_serve_full(sk, script, m, gold, card)}
    out["twins"] = run_serve_twins(script, m, gold, card)
    out["fleet"] = run_serve_fleet(sk, script, m, gold, card)
    out["cli"] = finish_serve_clis(gold, script, clis, card)
    print(f"phase 15 (serving) took {time.perf_counter() - t15:.1f} s")
    return out


def start_control_clis(gold, here: str, tmp: str):
    """Phase 16d's CLI processes, started together: the controller's
    three CLIs in ``tmp`` (the first saves the artifact there) and the
    committed spike artifact's ``repro`` and ``trace`` from the checkout,
    each read by a thread that notes when it ended."""
    import threading

    t0 = time.perf_counter()
    procs, ended, threads = {}, {}, []

    def reap(key, proc):
        ended[key] = (*proc.communicate(timeout=900), time.perf_counter() - t0)

    committed = gold["committed"]
    runs = [(args, tmp) for args in gold["config"]["cli"]]
    runs += [(committed["repro"]["args"], here), (committed["trace"]["args"], here)]
    for args, cwd in runs:
        key = " ".join(args)
        procs[key] = subprocess.Popen(
            [sys.executable, "-m", "tpu_paxos_torch", *args, "--device", DEV],
            cwd=cwd, env=_port_env(here), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        threads.append(threading.Thread(target=reap, args=(key, procs[key]), daemon=True))
        threads[-1].start()
    return procs, threads, ended


def finish_control_clis(gold, script, here: str, tmp: str, started, card: str) -> dict:
    """Phase 16d: each CLI's stdout against the JAX CLI's, the saved
    artifact's bytes against JAX's, then ``repro`` of the saved artifact."""
    procs, threads, ended = started
    for th in threads:
        th.join()
    committed = gold["committed"]
    out = {}

    def fail(key, stderr):
        print(stderr[-3000:], file=sys.stderr)
        for p in procs.values():
            p.kill()
        raise SystemExit(f"'{key}' disagrees with the JAX CLI's")

    for key, proc in procs.items():
        stdout, stderr, wall = ended[key]
        sha = hashlib.sha256(stdout.encode()).hexdigest()
        if key in gold["cli"]:
            want = gold["cli"][key]
            got = script.less_wall(json.loads(stdout.strip().splitlines()[-1]))
            ok = proc.returncode == want["rc"] and got == want["summary"]
            detail = f"summary_equal={got == want['summary']}"
        else:
            want = committed["repro" if key.startswith("repro") else "trace"]
            ok = proc.returncode == want["rc"] and sha == want["stdout_sha256"]
            detail = f"stdout_bytes={len(stdout.encode())} stdout_sha256={sha}"
        print(f"control CLI (python -m tpu_paxos_torch {key}): rc={proc.returncode} "
              f"wall_s={wall:.3f} {detail} | {card}")
        if not ok:
            fail(key, stderr)
        out[key] = wall
    art = _file_sha256(os.path.join(tmp, gold["config"]["artifact"]))
    if art != gold["cli"]["artifact_sha256"]:
        raise SystemExit(f"serve --control --save-artifact wrote {art}, JAX "
                         f"{gold['cli']['artifact_sha256']}")
    if _file_sha256(os.path.join(here, gold["config"]["committed_artifact"])) != committed[
            "artifact_sha256"]:
        raise SystemExit("the committed spike artifact changed under repro/trace")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_paxos_torch", *gold["config"]["repro"], "--device", DEV],
        cwd=tmp, env=_port_env(here), capture_output=True, text=True, timeout=900)
    sha = hashlib.sha256(proc.stdout.encode()).hexdigest()
    key = " ".join(gold["config"]["repro"])
    print(f"control CLI (python -m tpu_paxos_torch {key}): rc={proc.returncode} "
          f"wall_s={time.perf_counter() - t0:.3f} artifact_sha256={art} stdout_sha256={sha} | {card}")
    if proc.returncode != gold["cli"]["repro"]["rc"] or sha != gold["cli"]["repro"]["stdout_sha256"]:
        print(proc.stderr[-3000:], file=sys.stderr)
        raise SystemExit(f"'{key}' disagrees with the JAX CLI's")
    return out


def run_control_ab(script, m, gold, here: str, tmp: str, card: str) -> dict:
    """Phase 16a: ``spike_ab`` at ``bench.py``'s configuration, twice (the
    second counting runner builds), held against the committed
    ``BENCH_serve_control.json`` and the JAX golden."""
    from tpu_paxos_torch.fleet import envelope as envm

    with open(os.path.join(here, "BENCH_serve_control.json")) as f:
        bench = json.load(f)
    path = os.path.join(tmp, "spike_ab.json")
    t0 = time.perf_counter()
    first = script.control_ab(m, artifact_path=path, device=DEV)
    first_s = time.perf_counter() - t0
    before = envm.cache_misses()
    ab, wall, syncs, peak = _serve_timed(
        lambda: script.control_ab(m, artifact_path=path, device=DEV))
    builds = envm.cache_misses() - before
    a = gold["config"]["ab"]
    calls = (ab["off"]["dispatches"] + 2 * ab["on"]["dispatches"]) * a["windows_per_dispatch"] \
        * a["rounds_per_window"]
    print(f"control_ab_bench (I={a['n_instances']}, {a['n_values']} values, off + on + replay): "
          f"wall_s={wall:.3f} (first {first_s:.3f}) round_calls={calls} "
          f"ms_per_round={wall / calls * 1e3:.3f} syncs_per_round={syncs / calls:.2f} "
          f"peak_gb={peak:.3f} runner_builds_measured={builds} "
          f"breach_windows off={ab['off']['breach_windows']} on={ab['on']['breach_windows']} "
          f"sheds={ab['sheds']} decisions={ab['decisions']} "
          f"replay={ab['replay']['decision_log_sha256'][:8]} match={ab['replay']['match']} | {card}")
    checks = {
        "off": ab["off"] == bench["off"],
        "on": ab["on"] == bench["on"],
        "breach_windows": (ab["off"]["breach_windows"], ab["on"]["breach_windows"]) == (
            bench["breach_windows_off"], bench["breach_windows_on"]),
        "sheds": (ab["sheds"], ab["decisions"]) == (bench["sheds"], bench["decisions"]),
        "gray": ab["gray_shed_violations"] == bench["gray_shed_violations"] == [],
        "replay": ab["replay"]["match"] and ab["replay"]["decision_log_sha256"] == bench[
            "replay"]["decision_log_sha256"],
        "warm": builds == bench["warm_compiles_measured"] == 0,
        "golden": script.less_wall({k: v for k, v in ab.items() if k != "replay"}) == gold["ab"],
        "twice": ab == first,
        "ok": ab["ok"],
    }
    if not all(checks.values()):
        raise SystemExit(f"control_ab_bench disagrees with BENCH_serve_control.json: {checks}")
    return {"wall_s": wall, "round_calls": calls, "ms_per_round": wall / calls * 1e3,
            "syncs_per_round": syncs / calls, "runner_builds": builds}


def run_control_full(sk, script, m, gold, card: str) -> dict:
    """Phase 16b: one armed controlled run at 15a's full width."""
    import numpy as np

    from tpu_paxos_torch.serve import control as ctl
    from tpu_paxos_torch.serve import driver as drv
    from tpu_paxos_torch.utils import prng

    sk.reset_counts()
    with lane_counts(sk) as shapes:
        rep, wall, syncs, peak = _serve_timed(lambda: script.control_full_run(m, device=DEV))
    launches = dict(sk.LAUNCHES)
    rec = script.control_report_record(rep)
    f = gold["config"]["full"]
    out = _serve_line(f"control_spike_full (I={rep.cfg.n_instances}, {rep.n_values} values, "
                      f"spike x{f['spike_factor']})", rep, wall, syncs, peak, launches, card)
    out.update(sheds=rep.shed_count, decisions=len(rep.decisions))
    print(f"control_spike_full: sheds={rep.shed_count} decisions="
          f"{[(d['dispatch'], d['action']) for d in rep.decisions]} "
          f"breach_windows={rep.slo['breach_windows']} | {card}")
    if rec != gold["full"]:
        raise SystemExit(f"control_spike_full disagrees with its JAX golden: "
                         f"{_dict_diff(rec, gold['full'])}")
    if min(launches.values()) < 1 or not all(x == [1] * len(x) for x in shapes.values()):
        raise SystemExit("control_spike_full: a simkern kernel did not launch on one-lane operands")
    # the sample: the first two dispatches again, the first launches held
    # against the plain version on their own operands
    sc = script.SERVE
    streams, arrs, prios = script.control_full_inputs(m)
    plan = ctl.ControlledPlan(streams, arrs, prios, sc["rounds_per_window"])
    k, s = rep.admit_width, sc["windows_per_dispatch"]
    vb = drv.vid_bound_of(streams)
    root = prng.root_key(rep.cfg.seed)
    cs, qc = ctl.init_control_state(rep.cfg, streams, vb, root, window_rounds=sc["window_rounds"],
                                    device=DEV)
    fn = ctl.control_window_for(rep.cfg, qc, vb, sc["rounds_per_window"], sc["window_rounds"],
                                device=DEV)
    stats = {}
    with check_launches(sk, SNAP_REPS, stats, limit=SERVE_CHECK):
        for d in range(2):
            blocks = [plan.take(d * s + i, k) for i in range(s)]
            cs = fn(cs, root, *(np.stack([b[j] for b in blocks]) for j in range(3)))[0]
    out["checked"] = _summarize_checked("control_spike_full one-lane operands (first 2 dispatches)",
                                        stats)
    del cs, rep
    torch.cuda.empty_cache()
    return out


def run_control_fleet(sk, script, m, gold, card: str) -> dict:
    """Phase 16c: the controlled 256-lane fleet at 15c's 128000-milli cell
    and its kernel sample."""
    lanes = gold["config"]["fleet"]["lanes"]
    sk.reset_counts()
    stats = {}
    # the run is the sample: its first launches' operands are copied in it
    # and held against the plain version after it
    with check_launches(sk, SNAP_REPS, stats, lanes=lanes, limit=SERVE_CHECK, defer=True), \
            lane_counts(sk) as shapes:
        rep, wall, syncs, peak = _serve_timed(lambda: script.control_fleet_run(m, device=DEV))
    launches = dict(sk.LAUNCHES)
    rec = script.control_fleet_record(m, rep)
    out = _serve_line(f"control_fleet_{lanes} @ {gold['config']['fleet']['rate_milli']} milli "
                      f"(I={rep.cfg.n_instances})", rep, wall, syncs, peak, launches, card,
                      lanes=lanes)
    want = gold["fleet"]
    print(f"control_fleet_{lanes}: flagged={len(rec['flagged'])} shed={rec['shed_total']} "
          f"decisions={sum(rec['lane_decisions'])} lanes_off="
          f"{[i for i in range(lanes) if rec['decision_log_sha256'][i] != want['decision_log_sha256'][i]]}")
    if rec != want:
        raise SystemExit(f"control fleet disagrees with its JAX golden: {_dict_diff(rec, want)}")
    if min(launches.values()) < 1 or not all(x == [lanes] * len(x) for x in shapes.values()):
        raise SystemExit(f"control fleet: a simkern kernel did not launch on {lanes}-lane operands")
    out["checked"] = _summarize_checked(f"control_fleet_{lanes} {lanes}-lane operands", stats)
    del rep
    torch.cuda.empty_cache()
    return out


def run_control(goldens, here: str, card: str) -> dict:
    """Phase 16: the admission controller on the card."""
    from tpu_paxos_torch.core import simkern as sk

    gold = goldens["control"]
    script = _goldens_script(here)
    m = script.serve_modules(port=True)
    t16 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        clis = start_control_clis(gold, here, tmp)
        out = {"ab": run_control_ab(script, m, gold, here, tmp, card)}
        out["full"] = run_control_full(sk, script, m, gold, card)
        out["fleet"] = run_control_fleet(sk, script, m, gold, card)
        out["cli"] = finish_control_clis(gold, script, here, tmp, clis, card)
    print(f"phase 16 (admission controller) took {time.perf_counter() - t16:.1f} s")
    return out


MC_CHECK = 16  # launches of each kernel held against the plain version in 17a


def start_mc_clis(gold, here: str, tmp: str):
    """Phase 17's CLI processes, started together beside 17a: ``mc
    --scope gray --json``, ``mc --scope nosuch`` and the takeover recall
    (``mc --scope quick`` armed, one counterexample shrunk into ``tmp``),
    each read by a thread that notes when it ended."""
    import threading

    t0 = time.perf_counter()
    rc = gold["config"]["recall"]
    runs = {
        "gray": (gold["config"]["gray_cli"], {}),
        "nosuch": (gold["config"]["nosuch_cli"], {}),
        "recall": (["mc", "--scope", rc["scope"], "--max-counterexamples",
                    str(rc["max_counterexamples"]), "--triage-dir", tmp, "--json", "--quiet"],
                   {"TPU_PAXOS_SEEDED_WEDGE": rc["wedge"]}),
    }
    procs, ended, threads = {}, {}, []

    def reap(key, proc):
        ended[key] = (*proc.communicate(timeout=900), time.perf_counter() - t0)

    for key, (args, env) in runs.items():
        procs[key] = subprocess.Popen(
            [sys.executable, "-m", "tpu_paxos_torch", *args, "--device", DEV], cwd=here,
            env=_port_env(here, env), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        threads.append(threading.Thread(target=reap, args=(key, procs[key]), daemon=True))
        threads[-1].start()
    return procs, threads, ended


def finish_mc_clis(gold, script, here: str, tmp: str, started, card: str) -> dict:
    """17b's fault recall and 17d's CLIs against JAX's: the recall's
    summary, certificate failure and artifact bytes, then ``repro`` of
    the artifact with the wedge armed; the gray line less its timing and
    device; the unknown scope's exit code and stdout."""
    procs, threads, ended = started
    for th in threads:
        th.join()
    out = {}

    def fail(key, what):
        print(ended[key][1][-3000:], file=sys.stderr)
        raise SystemExit(f"mc CLI '{key}' disagrees with JAX's: {what}")

    for key, proc in procs.items():
        stdout, _, wall = ended[key]
        out[key] = wall
        if key == "nosuch":
            want = gold["nosuch_cli"]
            ok = (proc.returncode, stdout) == (want["rc"], want["stdout"])
            print(f"mc CLI ({' '.join(gold['config']['nosuch_cli'])}): rc={proc.returncode} "
                  f"wall_s={wall:.3f} | {card}")
            if not ok:
                fail(key, f"rc {proc.returncode}")
            continue
        summary = json.loads(stdout.strip().splitlines()[-1])
        if key == "gray":
            want = gold["gray_cli"]
            got = script.mc_less(summary)
            print(f"mc CLI ({' '.join(gold['config']['gray_cli'])}): rc={proc.returncode} "
                  f"wall_s={wall:.3f} lanes_per_sec={summary['lanes_per_sec']} "
                  f"compiles_per_chunk={summary['compiles_per_chunk']} "
                  f"summary_equal={got == want['summary']} | {card}")
            if (proc.returncode, summary["certificate_failures"], got) != (
                    want["rc"], want["certificate_failures"], want["summary"]):
                fail(key, _dict_diff(got, want["summary"]))
            continue
        want = gold["recall"]
        cx = summary["counterexamples"][0]
        art = cx.get("artifact", "")
        sha = _file_sha256(art) if art else ""
        print(f"mc recall (takeover, quick scope): rc={proc.returncode} wall_s={wall:.3f} "
              f"index={cx['scenario']['index']} violation={cx['violation']!r} "
              f"chunks_run={summary['chunks_run']} artifact={os.path.basename(art)} "
              f"artifact_sha256={sha} shrink_s={cx.get('shrink_seconds')} "
              f"certificate_failures={summary['certificate_failures']} | {card}")
        checks = {
            "rc": proc.returncode == 1,
            "summary": script.mc_less(summary) == want["summary"],
            "certificate": summary["certificate_failures"] == want["certificate_failures"],
            "artifact": (os.path.basename(art), sha) == (want["artifact"], want["artifact_sha256"]),
        }
        if not all(checks.values()):
            fail(key, checks)
        rproc, rwall = _repro_cli(here, art, {"TPU_PAXOS_SEEDED_WEDGE": gold["config"]["recall"][
            "wedge"]})
        rsha = _sha_text(rproc.stdout)
        print(f"mc recall repro (python -m tpu_paxos_torch repro {os.path.basename(art)} --json): "
              f"rc={rproc.returncode} wall_s={rwall:.3f} stdout_sha256={rsha} | {card}")
        if rproc.returncode != 0 or rsha != want["repro_stdout_sha256"]:
            print(rproc.stderr[-3000:], file=sys.stderr)
            raise SystemExit("the mc recall artifact's repro disagrees with JAX's")
    return out


#: 17a runs the quick scope's first this many chunks (of 58)
QUICK_CHUNKS = 16


def _mc_prefix(want: dict, chunks: int) -> dict:
    """JAX's summary of a whole scope cut to its first ``chunks`` chunks:
    what a run with ``chunk_limit=chunks`` reports (the verdict nibbles,
    lanes and runner builds of those chunks, the scope's own fields as
    they are)."""
    lanes = min(chunks * want["chunk_lanes"], want["lanes_judged"])
    bits = want["verdict_bits"][:lanes]
    return dict(want, chunks_run=chunks, lanes_judged=lanes, verdict_bits=bits,
                verdict_bits_sha256=hashlib.sha256(bits.encode()).hexdigest(),
                compiles_per_chunk=want["compiles_per_chunk"][:chunks])


def run_mc_scopes(sk, script, m, gold, card: str) -> dict:
    """17a: the four quick scopes in ``make mc-quick``'s order, cold
    envelopes, each against its certificate and JAX's summary (the zero
    pattern of runner builds included); the quick scope's first
    :data:`QUICK_CHUNKS` chunks, against the prefix of both.  In the quick
    scope's own run, its first two chunks are held lane by lane against
    JAX's decision logs,
    and the first launches of each kernel against the plain version (on
    snapshots of their operands, after the run)."""
    from tpu_paxos_torch.fleet import envelope as envm
    from tpu_paxos_torch.serve import control as ctl

    envm.clear_cache()
    ctl.clear_cache()
    scopes = m.mc.load_scopes()
    certs = m.mc.load_certificates()
    want = gold["quick_scopes"]["summaries"]
    out, total = {}, {"store_accepts": 0, "accum_acks": 0}
    lanes_of = {"quick": 16, "gray": 16, "control": 1}
    n_chunks = gold["config"]["lane_chunks"]
    limit = {"quick": QUICK_CHUNKS}
    stats = {}
    for name in gold["config"]["quick_scopes"]:
        scope = scopes[name]
        quick = name == "quick"
        check = check_launches(sk, SNAP_REPS, stats, lanes=16, limit=MC_CHECK, defer=True) \
            if quick else contextlib.nullcontext()
        sk.reset_counts()
        with check, script.mc_first_reports(m, n_chunks if quick else 0) as reports, \
                lane_counts(sk) as shapes, dispatch_log() as seen:
            s, wall, syncs, peak = _serve_timed(lambda: m.mc.run_for(scope)(
                scope, verbose=False, chunk_limit=limit.get(name), device=DEV))
        launches = dict(sk.LAUNCHES)
        rounds = sum(x[1] for x in seen)
        disp_s = sum(x[2] for x in seen)
        fails = m.mc.check_certificate(certs[name], s, m.mc.enum_for(scope))
        got = script.mc_less(s)
        jax = _mc_prefix(want[name], limit[name]) if name in limit else want[name]
        print(f"mc scope {name}: wall_s={wall:.3f} lanes={s['lanes_judged']} "
              f"lanes_per_sec={s['lanes_judged'] / wall:.2f} "
              f"chunks={s['chunks_run']} of {s['chunks']} "
              f"dispatches={len(seen)} round_calls={rounds} "
              f"ms_per_round={disp_s / max(rounds, 1) * 1e3:.3f} "
              f"syncs_per_round={syncs / max(rounds, 1):.2f} peak_gb={peak:.3f} "
              f"compiles_per_chunk={s['compiles_per_chunk'][:4]}... "
              f"verdict_bits_sha256={s['verdict_bits_sha256']} certificate_failures={fails} "
              f"launches={json.dumps(launches, sort_keys=True)} | {card}")
        if not s["ok"] or s["anomalies"] or fails or got != jax:
            raise SystemExit(f"mc scope {name} disagrees with its certificate or JAX's summary: "
                             f"{fails} {_dict_diff(got, jax)}")
        lanes = lanes_of.get(name)
        if lanes is None:
            if any(shapes.values()):
                raise SystemExit(f"mc scope {name} launched a simkern kernel")
        elif min(launches.values()) < 1 or not all(x == [lanes] * len(x) for x in shapes.values()):
            raise SystemExit(f"mc scope {name}: a simkern kernel did not launch on {lanes}-lane "
                             "operands")
        for k in total:
            total[k] += launches[k]
        out[name] = {"wall_s": wall, "lanes_per_sec": s["lanes_judged"] / wall,
                     "round_calls": rounds, "ms_per_round": disp_s / max(rounds, 1) * 1e3,
                     "syncs_per_round": syncs / max(rounds, 1), "launches": launches}
        if not quick:
            continue
        shas = script.mc_lane_shas(m, reports)
        off = [i for i, (a, b) in enumerate(zip(shas, gold["quick_lanes"])) if a != b]
        print(f"mc quick first {n_chunks} chunks of its run: {len(shas)} lanes, "
              f"decision logs off JAX's: {off} | {card}")
        if shas != gold["quick_lanes"]:
            raise SystemExit("the quick scope's first chunks disagree with JAX lane for lane")
        del reports
    out["launches"] = total
    out["checked"] = _summarize_checked("mc quick 16-lane operands (its first launches)", stats)
    torch.cuda.empty_cache()
    return out


def run_mc_control_recall(script, m, gold, here: str, tmp: str, card: str) -> dict:
    """17b, the controller: the tiny host scope clean and with
    ``shed-on-gray`` armed: the summaries and the mc-control artifacts'
    bytes equal JAX's; then ``repro`` and ``trace`` of the first artifact,
    the variable unset, print JAX's stdout with its exit code."""
    import threading

    t0 = time.perf_counter()
    got = script.mc_tiny_control(m, tmp, device=DEV)
    want = gold["tiny_control"]
    arts = {n: open(os.path.join(tmp, n)).read() for n in sorted(os.listdir(tmp))}
    print(f"mc control recall (shed-on-gray, tiny scope): wall_s={time.perf_counter() - t0:.3f} "
          f"counterexamples={len(got['wedged']['counterexamples'])} artifacts={sorted(arts)} "
          f"bytes_equal={arts == want['artifacts']} | {card}")
    if (script.mc_less(got["clean"]), script.mc_less(got["wedged"]), arts) != (
            want["clean"], want["wedged"], want["artifacts"]):
        raise SystemExit("the controller recall disagrees with JAX's summaries or artifact bytes")
    ended = {}
    env = _port_env(here)
    env.pop("TPU_PAXOS_SEEDED_WEDGE", None)

    def run(key):
        ended[key] = subprocess.run(
            [sys.executable, "-m", "tpu_paxos_torch", *key.split(), "--device", DEV], cwd=tmp,
            env=env, capture_output=True, text=True, timeout=600)
    threads = [threading.Thread(target=run, args=(k,)) for k in want["cli"]]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for key, w in want["cli"].items():
        proc = ended[key]
        print(f"mc control CLI (python -m tpu_paxos_torch {key}): rc={proc.returncode} "
              f"stdout_sha256={_sha_text(proc.stdout)} | {card}")
        if (proc.returncode, proc.stdout) != (w["rc"], w["stdout"]):
            print(proc.stderr[-3000:], file=sys.stderr)
            raise SystemExit(f"'{key}' disagrees with the JAX CLI's")
    return {"wall_s": time.perf_counter() - t0}


def run_mc_full_prefix(script, m, gold, card: str) -> dict:
    """17c: the full scope's first chunks, their verdict bits the prefix
    of its certificate's."""
    scope = m.mc.load_scopes()["full"]
    pinned = m.mc.load_certificates()["full"]
    s, wall, syncs, peak = _serve_timed(lambda: m.mc.run_scope(
        scope, verbose=False, chunk_limit=gold["config"]["full_chunks"], device=DEV))
    fails = m.mc.check_certificate(
        dict(pinned, verdict_bits=pinned["verdict_bits"][:len(s["verdict_bits"])]), s,
        m.mc.enum_for(scope))
    print(f"mc scope full (first {s['chunks_run']} of {s['chunks']} chunks): wall_s={wall:.3f} "
          f"lanes_per_sec={s['lanes_judged'] / wall:.2f} verdict_prefix={s['verdict_bits']} "
          f"certificate_failures={fails} | {card}")
    if fails or not s["ok"] or s["scenarios_reduced"] != pinned["scenarios_reduced"]:
        raise SystemExit(f"the full scope's prefix disagrees with its certificate: {fails}")
    return {"wall_s": wall}


def run_mc(goldens, here: str, card: str) -> dict:
    """Phase 17: model checking on the card."""
    from tpu_paxos_torch.core import simkern as sk

    gold = goldens["mc"]
    script = _goldens_script(here)
    m = script.mc_modules(port=True)
    t17 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        recall_dir, ctl_dir = os.path.join(tmp, "recall"), os.path.join(tmp, "ctl")
        os.makedirs(ctl_dir)
        clis = start_mc_clis(gold, here, recall_dir)
        out = {"scopes": run_mc_scopes(sk, script, m, gold, card)}
        out["control_recall"] = run_mc_control_recall(script, m, gold, here, ctl_dir, card)
        out["cli"] = finish_mc_clis(gold, script, here, recall_dir, clis, card)
    print(f"phase 17 (model checking) took {time.perf_counter() - t17:.1f} s")
    return out


EVOLVE_CHECK = 16  # launches of each kernel held against the plain version in 18a and 18b


def _evolve_cli_run(sk, argv: list, checked=None):
    """``python -m tpu_paxos_torch evolve <argv>`` through the CLI's entry
    point in this process, from a cold envelope: ``(exit code, summary,
    wall s, syncs, launches, lane counts, fleet dispatches)``; ``checked``
    wraps the run (a :func:`check_launches` block)."""
    from tpu_paxos_torch import __main__ as cli
    from tpu_paxos_torch.fleet import envelope as envm

    envm.clear_cache()
    buf = io.StringIO()
    ones = []
    sk.reset_counts()
    with checked or contextlib.nullcontext(), lane_counts(sk) as shapes, \
            dispatch_log(single=ones) as disp, contextlib.redirect_stdout(buf):
        rc, wall, syncs, _ = _serve_timed(lambda: cli.main(["evolve", *argv, "--device", DEV]))
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    return rc, summary, wall, syncs, dict(sk.LAUNCHES), shapes, (disp, ones)


def _evolve_line(label: str, summary: dict, wall, syncs, launches, logs, card: str) -> dict:
    """One run's line: its fleet dispatches and one-lane ``sim.run`` calls
    apart (round calls, ms a round), its syncs over both kinds' round
    calls."""
    disp, ones = logs
    rounds, secs = sum(d[1] for d in disp), sum(d[2] for d in disp)
    one_rounds, one_secs = sum(d[1] for d in ones), sum(d[2] for d in ones)
    rec = {"wall_s": wall, "lanes_per_sec": summary["lanes_total"] / wall,
           "dispatches": len(disp), "round_calls": rounds,
           "ms_per_round": secs / max(rounds, 1) * 1e3,
           "single_runs": len(ones), "single_round_calls": one_rounds,
           "single_ms_per_round": one_secs / max(one_rounds, 1) * 1e3,
           "syncs_per_round": syncs / max(rounds + one_rounds, 1), "launches": launches}
    print(f"{label}: wall_s={wall:.3f} lanes_total={summary['lanes_total']} "
          f"lanes_per_sec={rec['lanes_per_sec']:.2f} (evolve's own {summary['lanes_per_sec']}) "
          f"generations={summary['generations_run']} "
          f"compiles_per_generation={summary['compiles_per_generation']} "
          f"fleet_dispatches={len(disp)} round_calls={rounds} "
          f"ms_per_round={rec['ms_per_round']:.3f} one_lane_runs={len(ones)} "
          f"one_lane_round_calls={one_rounds} "
          f"one_lane_ms_per_round={rec['single_ms_per_round']:.3f} syncs={syncs} "
          f"syncs_per_round={rec['syncs_per_round']:.2f} (both kinds' round calls) "
          f"population_sha256={summary['population_sha256'][:16]} "
          f"launches={json.dumps(launches, sort_keys=True)} | {card}")
    return rec


def run_evolve_quick(sk, script, gold, here: str, tmp: str, stats: dict, card: str) -> dict:
    """18a: ``make evolve-quick``'s line through the port's CLI, its first
    16 launches of each kernel on 8-lane operands held against the plain
    version (on snapshots, after the run); the summary less the wall
    fields, the artifact's bytes and ``repro`` of it equal JAX's."""
    want = gold["quick"]
    lanes = 8
    rc, s, wall, syncs, launches, shapes, logs = _evolve_cli_run(
        sk, [*gold["config"]["quick"], "--triage-dir", tmp, "--quiet"],
        check_launches(sk, SNAP_REPS, stats, lanes=lanes, limit=EVOLVE_CHECK, defer=True))
    out = _evolve_line("evolve-quick (18a)", s, wall, syncs, launches, logs, card)
    got = script.evolve_less(s)
    sha = _file_sha256(s["artifact"]) if s["artifact"] else ""
    print(f"evolve-quick: rc={rc} summary_equal={got == want['summary']} "
          f"artifact={os.path.basename(s['artifact'] or '')} artifact_sha256={sha} "
          f"replay_match={s['replay_match']} | {card}")
    if (rc, got, sha) != (want["rc"], want["summary"], want["artifact_sha256"]):
        raise SystemExit(f"evolve-quick disagrees with JAX's: rc {rc}, "
                         f"{_dict_diff(got, want['summary'])}")
    if s["warm_compiles"] or s["compiles_per_generation"][0] < 1:
        raise SystemExit(f"evolve-quick: runner builds {s['compiles_per_generation']}")
    if min(launches.values()) < 1 or not all(lanes in x for x in shapes.values()):
        raise SystemExit(f"evolve-quick: a simkern kernel did not launch on {lanes}-lane operands")
    rproc, rwall = _repro_cli(here, s["artifact"], {})
    print(f"evolve-quick repro (python -m tpu_paxos_torch repro {os.path.basename(s['artifact'])} "
          f"--json): rc={rproc.returncode} wall_s={rwall:.3f} "
          f"stdout_sha256={_sha_text(rproc.stdout)} | {card}")
    if rproc.returncode != 0 or rproc.stdout != want["repro_stdout"]:
        print(rproc.stderr[-3000:], file=sys.stderr)
        raise SystemExit("evolve-quick's artifact replay disagrees with JAX's")
    return out


def run_evolve_axes(sk, script, gold, stats: dict, card: str) -> dict:
    """18b: the pure operators' seeded sweep; the member axis (no kernel
    launches); the serve axis, its first 16 launches of each kernel held
    against the plain version; the one-lane ``lane_causes`` case: each
    summary less the wall fields, and its triage files' bytes, equal
    JAX's."""
    m = script.evolve_modules(port=True)
    sweep = script.evolve_operator_sweep(m)
    print(f"evolve operator sweep ({len(sweep)} seeded draws): equal={sweep == gold['sweep']}")
    if sweep != gold["sweep"]:
        raise SystemExit("the evolve operators' sweep disagrees with JAX's")
    out = {}
    for key in ("member", "serve", "lane_causes"):
        check = check_launches(sk, SNAP_REPS, stats, limit=EVOLVE_CHECK, defer=True) \
            if key == "serve" else contextlib.nullcontext()
        sk.reset_counts()
        with check, lane_counts(sk) as shapes:
            run, wall, syncs, peak = _serve_timed(
                lambda key=key: script.evolve_axis(m, key, device=DEV))
        launches = dict(sk.LAUNCHES)
        s, want = run["summary"], gold[key]
        got = script.evolve_less(s)
        lanes = sorted({n for x in shapes.values() for n in x})
        print(f"evolve --axis {s['axis']} ({key}, 18b): wall_s={wall:.3f} "
              f"lanes_per_sec={s['lanes_total'] / wall:.2f} generations={s['generations_run']} "
              f"compiles_per_generation={s['compiles_per_generation']} "
              f"wedges={s['wedges_found']} files={len(run['files'])} syncs={syncs} "
              f"peak_gb={peak:.3f} launches={json.dumps(launches, sort_keys=True)} "
              f"lanes_per_launch={lanes} summary_equal={got == want['summary']} | {card}")
        if (got, run["files"]) != (want["summary"], want["files"]):
            raise SystemExit(f"evolve {key} disagrees with JAX's: "
                             f"{_dict_diff(got, want['summary'])}")
        if s["warm_compiles"] or s["compiles_per_generation"][0] < 1:
            raise SystemExit(f"evolve {key}: runner builds {s['compiles_per_generation']}")
        if key == "member" and any(launches.values()):
            raise SystemExit("the member axis launched a simkern kernel")
        if key == "serve" and min(launches.values()) < 1:
            raise SystemExit("the serve axis did not launch both simkern kernels")
        out[key] = {"wall_s": wall, "launches": launches}
    return out


def run_evolve_wide(sk, script, gold, card: str) -> dict:
    """18c: the card's default population (128 lanes, two generations,
    the duel-churn hunt) on the fleet axis through the CLI: the summary
    less the wall fields equals JAX's; lanes/s, ms and syncs a round."""
    from tpu_paxos_torch.fleet import runner as frun

    n = frun.default_lane_count(DEV)
    if str(n) != gold["config"]["wide"][1]:
        raise SystemExit(f"the card's default lane count is {n}, the golden's "
                         f"{gold['config']['wide'][1]}")
    want = gold["wide"]
    rc, s, wall, syncs, launches, shapes, logs = _evolve_cli_run(
        sk, [*gold["config"]["wide"], "--quiet"])
    out = _evolve_line(f"evolve --lanes {n} (18c)", s, wall, syncs, launches, logs, card)
    got = script.evolve_less(s)
    print(f"evolve --lanes {n}: rc={rc} summary_equal={got == want['summary']} | {card}")
    if (rc, got) != (want["rc"], want["summary"]):
        raise SystemExit(f"the {n}-lane evolve disagrees with JAX's: "
                         f"{_dict_diff(got, want['summary'])}")
    if min(launches.values()) < 1 or not all(x == [n] * len(x) for x in shapes.values()):
        raise SystemExit(f"the {n}-lane evolve: a simkern kernel did not launch on {n}-lane "
                         "operands")
    return out


def run_evolve(goldens, here: str, card: str) -> dict:
    """Phase 18: the selection loop on the card."""
    from tpu_paxos_torch.core import simkern as sk

    gold = goldens["evolve"]
    script = _goldens_script(here)
    t18 = time.perf_counter()
    stats = {}
    with tempfile.TemporaryDirectory() as tmp:
        out = {"quick": run_evolve_quick(sk, script, gold, here, tmp, stats, card)}
    out["axes"] = run_evolve_axes(sk, script, gold, stats, card)
    out["wide"] = run_evolve_wide(sk, script, gold, card)
    out["launches"] = {k: out["quick"]["launches"][k] + out["axes"]["serve"]["launches"][k]
                       + out["wide"]["launches"][k] for k in ("store_accepts", "accum_acks")}
    out["checked"] = _summarize_checked("evolve 18a (8-lane) and 18b serve operands", stats)
    print(f"phase 18 (selection loop) took {time.perf_counter() - t18:.1f} s; simkern launches "
          f"in 18a, 18b's serve axis and 18c: {json.dumps(out['launches'], sort_keys=True)}")
    return out


SHARDED_RANKS = 8  # phase 19's mesh: eight ranks on the one card
#: 19b's host checks run on this many of its 1e8 instances (the first)
NATIVE_19B_ROWS = 1 << 24
SHARDED_CHECK = 16  # launches of each kernel held per rank in 19a
SHARDED_FAST_N = 100_000_000  # 19b: BASELINE config 4's literal size
COLLECTIVE_REPS = 200  # idle collectives timed in a row in 19a


def run_sharded_sim(sk, script, goldens, card: str) -> dict:
    """19a: the sharded general engine at bench.py's record configuration
    on 8 ranks of the one card, then on the (2, 4) ``("dcn", "i")`` mesh
    with the first 16 launches of each kernel on every rank held."""
    from tpu_paxos_torch.harness import validate
    from tpu_paxos_torch.parallel import mesh as pmesh
    from tpu_paxos_torch.parallel import sharded_sim

    m = script.sharded_modules(port=True)
    gold = goldens["sharded_sim_2p20_d8"]
    cfg = script.sharded_sim_cfg(m, gold["config"])
    mesh = pmesh.make_instance_mesh(SHARDED_RANKS, device=DEV)
    res, wall, syncs, peak = _serve_timed(lambda: sharded_sim.run_sharded(cfg, mesh))
    launches, calls = mesh.launches, mesh.calls
    rec = script.sharded_record(m, cfg, None, res)
    rec["chosen_round_sha256"] = script.chosen_round_sha256(res.chosen_round)
    print(f"sharded sim (19a) I={cfg.n_instances} over {mesh.size} ranks (I_loc="
          f"{cfg.n_instances // mesh.size}, A={cfg.n_nodes}, P={len(cfg.proposers)}), one card, "
          f"the ranks exchanging through a shared store on the host: rounds={res.rounds} done={res.done} "
          f"chosen={rec['chosen']} wall_s={wall:.3f} ms_per_round={wall / res.rounds * 1e3:.3f} "
          f"syncs_per_round={syncs / res.rounds:.2f} (all ranks) "
          f"collectives_per_round={calls[0] / res.rounds:.2f} (each rank) peak_gb={peak:.3f} "
          f"launches_per_rank={json.dumps(launches)} | {card}")
    validate.check_all(res.learned, res.expected_vids)
    want = {k: gold[k] for k in rec}
    if rec != want:
        raise SystemExit(f"sharded sim (19a) disagrees with the JAX golden at D=8: "
                         f"{_dict_diff(rec, want)}")
    if any(min(n.values()) < 1 for n in launches):
        raise SystemExit("sharded sim (19a): a rank did not launch both simkern kernels")
    print(f"sharded sim decision_log_sha256={rec['decision_log_sha256']} chosen_round_sha256="
          f"{rec['chosen_round_sha256']} (match the JAX golden at D=8)")
    mesh2 = pmesh.make_instance_mesh(SHARDED_RANKS, dcn_hosts=2, device=DEV)
    stats, held = {}, {}
    with check_launches(sk, SNAP_REPS, stats, limit=SHARDED_CHECK, defer=True, held=held):
        res2, wall2, _, _ = _serve_timed(lambda: sharded_sim.run_sharded(cfg, mesh2))
    per_rank = {}
    for (rank, name), n in sorted(held.items(), key=str):
        per_rank.setdefault(f"rank {rank}", {})[name] = n
    same = _same_result(res, res2)
    rec2 = script.sharded_record(m, cfg, None, res2)
    print(f"sharded sim on the {mesh2.shape} {mesh2.axis_names} mesh: rounds={res2.rounds} "
          f"wall_s={wall2:.3f} (with snapshots) equal_to_1d={same} "
          f"held_per_rank={json.dumps(per_rank, sort_keys=True)} | {card}")
    if not same or rec2 != {k: goldens["sharded_sim_2p20_2x4"][k] for k in rec2}:
        raise SystemExit("sharded sim on the (2, 4) mesh disagrees with D=8 or its golden")
    full = {"store_accepts": SHARDED_CHECK, "accum_acks": SHARDED_CHECK}
    if any(per_rank.get(f"rank {r}") != full for r in range(mesh2.size)):
        raise SystemExit(f"sharded sim: not {SHARDED_CHECK} launches of each kernel on every rank")
    checked = _summarize_checked(f"sharded sim, {SHARDED_CHECK} launches a kernel on each of "
                                 f"{mesh2.size} ranks (I_loc={cfg.n_instances // mesh2.size})", stats)
    # what one collective costs with nothing else running: the round's
    # packs are a few dozen int64 values
    width = 1 + cfg.n_nodes + 3 * len(cfg.proposers) + 1
    t0 = time.perf_counter()
    mesh.run(lambda comm: [comm.exchange([0] * width) for _ in range(COLLECTIVE_REPS)])
    coll_ms = (time.perf_counter() - t0) / COLLECTIVE_REPS * 1e3
    print(f"sharded sim: one exchange of {width} int64 a rank over {mesh.size} thread ranks, "
          f"idle: {coll_ms:.3f} ms ({COLLECTIVE_REPS} in a row); {calls[0] / res.rounds:.2f} a round "
          f"-> {coll_ms * calls[0] / res.rounds:.3f} ms of the round's {wall / res.rounds * 1e3:.3f} "
          f"| {card}")
    return {"launches": launches, "calls": calls, "wall_s": wall, "rounds": res.rounds,
            "checked": checked, "collective_ms": coll_ms}


def run_sharded_fast(script, goldens, card: str) -> dict:
    """19b: ``sharded_choose_all`` over 7 nodes and 1e8 instances on 8
    ranks of the one card (twice: the second on the chosen state), then
    the (2, 4) mesh at the golden's size against the JAX golden."""
    from tpu_paxos_torch.parallel import mesh as pmesh
    from tpu_paxos_torch.parallel import sharded

    n, a = SHARDED_FAST_N, 7
    mesh = pmesh.make_instance_mesh(SHARDED_RANKS, device=DEV)
    torch.cuda.reset_peak_memory_stats()
    states = sharded.init_sharded_state(mesh, n, a)
    vids = pmesh.shard_instances(mesh, torch.arange(n, dtype=torch.int32, device=DEV))
    step = sharded.sharded_choose_all(mesh, proposer=0, quorum=a // 2 + 1)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, n_chosen = step(states, vids)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        learned_ok = all(bool((s.learned == v[None]).all()) for s, v in zip(states, vids))
        rep_ok = all(torch.equal(s.promised, states[0].promised)
                     and torch.equal(s.max_seen, states[0].max_seen) for s in states)
        if n_chosen != n or not learned_ok or not rep_ok:
            raise SystemExit(f"sharded fast (19b): n_chosen={n_chosen} learned_ok={learned_ok} "
                             f"replicated_equal={rep_ok}")
    gb = sum(x.numel() * x.element_size() for s in states for x in s) / 1e9
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the host checks of the 1e8 run's first NATIVE_19B_ROWS instances,
    # numpy against native, in a child process beside what follows:
    # learned [I, A] and the chosen log
    rows = NATIVE_19B_ROWS
    native_19b = start_native_compare(
        {"learned": torch.cat([s.learned for s in states], dim=1)[:, :rows].T.contiguous()
         .cpu().numpy(),
         "chosen_vid": torch.cat([s.learned[0] for s in states])[:rows].cpu().numpy(),
         "chosen_ballot": torch.cat([s.acc_ballot[0] for s in states])[:rows].cpu().numpy()},
        1 << 27, rows, f"19b, sharded fast at {n} x {a}, its first {rows} instances", card)
    print(f"sharded fast (19b) {n} instances x {a} nodes over {mesh.size} ranks: n_chosen={n_chosen} "
          f"walls_s={[round(w, 4) for w in walls]} instances_per_sec={n / walls[-1]:.4g} "
          f"(8 ranks on one card, not a multi-chip number) state_gb={gb:.2f} "
          f"peak_gb={peak:.2f} learned_rows_equal_vids=True replicated_equal=True | {card}")
    del states, vids
    torch.cuda.empty_cache()
    m = script.sharded_modules(port=True)
    gold = goldens["sharded_fast"]
    t0 = time.perf_counter()
    got = script.sharded_fast_golden(m, gold["n_instances"], gold["n_nodes"], gold["mesh"],
                                     device=DEV)
    print(f"sharded fast on the {gold['mesh']} mesh at {gold['n_instances']}: "
          f"n_chosen={got['n_chosen']} wall_s={time.perf_counter() - t0:.3f} (with the gather "
          f"to the host) equal_to_golden={got == gold} | {card}")
    if got != gold:
        raise SystemExit(f"sharded fast on the (2, 4) mesh disagrees with the JAX golden: "
                         f"{_dict_diff(got, gold)}")
    torch.cuda.empty_cache()
    return {"walls_s": walls, "instances_per_sec": n / walls[-1], "peak_gb": peak,
            "native": native_19b}


#: 19c's CLIs; ``cli_4_4_10_mesh8`` left the script for phase 20's room
#: (``tests/test_torch_sharded_cuda.py`` runs it)
SHARDED_CLIS = ("fast_cli_2p23_mesh8", "sharded_repro")


def start_sharded_clis(goldens, here: str, keys=SHARDED_CLIS):
    """19c's CLI processes, started together: ``5 8192 1024 --engine=fast
    --mesh 8 --json`` and ``repro --json`` of the committed sharded
    artifact in its directory (and ``4 4 10 ... --mesh 8`` when
    ``keys`` names it)."""
    data = os.path.join(here, "tpu_paxos_torch", "data")
    runs = {
        "cli_4_4_10_mesh8": (goldens["cli_4_4_10_mesh8"]["args"], here),
        "fast_cli_2p23_mesh8": (goldens["fast_cli_2p23_mesh8"]["args"], here),
        "sharded_repro": (["repro", goldens["sharded_repro"]["artifact"], "--json"], data),
    }
    runs = {key: runs[key] for key in keys}
    return {key: (subprocess.Popen(
        [sys.executable, "-m", "tpu_paxos_torch", *args, "--device", DEV], cwd=cwd,
        env=_port_env(here, {"TPU_PAXOS_DETERMINISTIC": "1"}), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True), time.perf_counter()) for key, (args, cwd) in runs.items()}


def finish_sharded_clis(goldens, started, card: str) -> None:
    """19c: each CLI's stdout against the JAX CLI's golden."""
    for key, (proc, t0) in started.items():
        stdout, stderr = proc.communicate(timeout=600)
        want = goldens[key]["stdout"]
        print(f"sharded CLI {key} (python -m tpu_paxos_torch {' '.join(proc.args[3:-2])}): "
              f"rc={proc.returncode} wall_s={time.perf_counter() - t0:.3f} "
              f"stdout_sha256={_sha_text(stdout)} equal={stdout == want} | {card}")
        if proc.returncode != 0 or stdout != want:
            print(stderr[-3000:], file=sys.stderr)
            raise SystemExit(f"{key} disagrees with the JAX CLI's")


def run_sharded(goldens, here: str, card: str) -> dict:
    """Phase 19: the instance-sharded engines on the card."""
    from tpu_paxos_torch.core import simkern as sk

    script = _goldens_script(here)
    t19 = time.perf_counter()
    print(f"phase 19: {SHARDED_RANKS} ranks, threads of this process, all on "
          f"{torch.cuda.get_device_name(0)} (cuda:0), collectives through a HashStore they share | {card}")
    clis = start_sharded_clis(goldens, here)
    try:
        out = {"sim": run_sharded_sim(sk, script, goldens, card),
               "fast": run_sharded_fast(script, goldens, card)}
    except BaseException:
        for proc, _ in clis.values():
            proc.kill()
        raise
    finish_sharded_clis(goldens, clis, card)
    print(f"phase 19 (instance-sharded engines) took {time.perf_counter() - t19:.1f} s")
    return out


TILE_RANKS = 8  # phase 20's mesh: eight ranks on the one card
TILE_CHECK = 16  # launches of each kernel held per rank in 20a


def run_tile_fleet(sk, goldens, mesh, card: str, untiled_s: float | None = None) -> dict:
    """20a: phase 9's headline cycle (128 lanes) on the 8-rank tile, 16
    lanes a rank, with the launch counts of this one run kept per rank and
    the first 16 launches of each kernel on every rank held against the
    plain version (their operands copied in the run, held after it).  The
    run's syncs are counted in it, so ``untiled_s`` is phase 9's headline
    run under the same instrumentation (its check run)."""
    import numpy as np

    from tpu_paxos_torch.fleet import runner as frun

    gold = goldens["fleet"]
    cfg, wl, gates = _fleet_config(goldens)
    seeds, sch, knobs = _fleet_cycle(goldens, "headline")
    n = len(seeds)
    runner = frun.FleetRunner(cfg, wl, gates, mesh=mesh, device=DEV)
    stats, held = {}, {}
    with check_launches(sk, SNAP_REPS, stats, limit=TILE_CHECK, defer=True, held=held):
        rep, wall, syncs, peak = _serve_timed(lambda: runner.run(seeds, sch, knobs=knobs))
    launches = mesh.launches  # this run's, per rank
    v = rep.verdict
    gc = gold["headline"]
    bad = [f for f in v._fields if np.asarray(getattr(v, f)).tolist() != gc[f]]
    off = [i for i in range(n) if _lane_sha(rep, i, gold["stride"]) != gc["decision_log_sha256"][i]]
    rank_rounds = sum(rep.rank_iterations)
    out = {"launches": launches, "wall_s": wall, "rank_iterations": rep.rank_iterations,
           "ms_per_rank_round": wall / rank_rounds * 1e3,
           "syncs_per_rank_round": syncs / rank_rounds, "lanes_per_sec": n / wall,
           "peak_gb": peak}
    print(f"tiled fleet (20a) headline, {n} lanes over {mesh.size} ranks ({n // mesh.size} a "
          f"rank, I={cfg.n_instances}), one card: wall_s={wall:.3f} round_calls_per_rank="
          f"{rep.rank_iterations} ms_per_rank_round={out['ms_per_rank_round']:.3f} "
          f"syncs_per_rank_round={out['syncs_per_rank_round']:.2f} "
          f"lanes_per_sec={n / wall:.2f} peak_gb={peak:.3f} (with the held launches' operand "
          f"copies) launches_per_rank={json.dumps(launches)} verdict_fields_off={bad} "
          f"decision_log_off={off} | {card}")
    if untiled_s:
        out["vs_untiled"] = wall / untiled_s
        print(f"tiled fleet (20a) wall over phase 9's untiled headline run, both with their "
              f"syncs counted and launches' operands copied: {wall:.3f} / {untiled_s:.3f} s = "
              f"{out['vs_untiled']:.2f}x | {card}")
    if bad or off or not v.ok.all():
        raise SystemExit("tiled fleet (20a) disagrees with phase 9's JAX golden")
    if any(min(c.values()) < 1 for c in launches):
        raise SystemExit("tiled fleet (20a): a rank did not launch both simkern kernels")
    per_rank = {}
    for (rank, name), k in sorted(held.items(), key=str):
        per_rank.setdefault(rank, {})[name] = k
    full = {"store_accepts": TILE_CHECK, "accum_acks": TILE_CHECK}
    if any(per_rank.get(r) != full for r in range(mesh.size)):
        raise SystemExit(f"tiled fleet (20a): not {TILE_CHECK} launches of each kernel held on "
                         f"every rank: {per_rank}")
    out["checked"] = _summarize_checked(
        f"tiled fleet (20a), {TILE_CHECK} launches a kernel on each of {mesh.size} ranks "
        f"({n // mesh.size}-lane operands)", stats)
    del rep
    torch.cuda.empty_cache()
    return out


def run_tile_serve(script, goldens, mesh, card: str) -> dict:
    """20b: phase 15c's 256-lane serve fleet at its 128000-milli cell on
    the 8-rank tile: the report, latency and SLO dicts and the breach
    vector equal 15c's golden; launches summed per rank over the run's
    dispatches."""
    gold = goldens["serve"]
    m = script.serve_modules(port=True)
    width = script.serve_fleet_width(m)
    rate = gold["config"]["fleet"]["rates"][-1]
    lanes = gold["config"]["fleet"]["lanes"]
    mesh.reset_totals()
    rep, wall, syncs, peak = _serve_timed(
        lambda: script.serve_fleet_run(m, rate, width, device=DEV, mesh=mesh))
    launches = [dict(c) for c in mesh.launch_totals]
    rec = script.serve_fleet_record(m, rep)
    want = gold["fleet"][str(rate)]
    line = _serve_line(f"tiled serve fleet (20b) {lanes} lanes @ {rate} milli over {mesh.size} "
                       f"ranks (I={rep.cfg.n_instances}, one card)", rep, wall, syncs, peak,
                       launches, card, lanes=lanes)
    print(f"tiled serve fleet (20b): flagged={len(rec['flagged'])} equal_to_15c_golden="
          f"{rec == want} lanes_off={[i for i in range(lanes) if rec['decision_log_sha256'][i] != want['decision_log_sha256'][i]]}")
    if rec != want:
        raise SystemExit(f"tiled serve fleet (20b) disagrees with 15c's JAX golden: "
                         f"{_dict_diff(rec, want)}")
    if any(min(c.values()) < 1 for c in launches):
        raise SystemExit("tiled serve fleet (20b): a rank did not launch both simkern kernels")
    del rep
    torch.cuda.empty_cache()
    return line


def run_tile_certificate(card: str) -> dict:
    """20c: the shard certificate's four lane drivers at D = 8 and on the
    (2, 4) mesh against ``shard_certificate.json``."""
    from tpu_paxos_torch.analysis import shard_audit

    out = {}
    for shape in ((TILE_RANKS, 1), (TILE_RANKS, 2)):
        results = {}
        t0 = time.perf_counter()
        fails = shard_audit.check_certificate((shape,), device=DEV, results=results)
        name = shard_audit.shape_name(shape)
        out[name] = time.perf_counter() - t0
        print(f"shard certificate (20c) at mesh {name}: entries={sorted(results)} "
              f"failures={fails} wall_s={out[name]:.3f} | {card}")
        if fails:
            raise SystemExit(f"the lane drivers disagree with shard_certificate.json: {fails[0]}")
    return out


def start_tile_clis(goldens, here: str, tmp: str):
    """20c's two CLI processes, started with 20a: fleet-quick's search and
    ``serve --fleet --lanes 8``, each on an 8-rank tile."""
    quick = goldens["search"]["fleet_quick"]
    runs = {
        "fleet": ["fleet", *quick["args"], "--mesh", str(TILE_RANKS), "--triage-dir", tmp,
                  "--quiet"],
        "serve": ["serve", "--fleet", "--lanes", "8", "--mesh", str(TILE_RANKS)],
    }
    return {key: (subprocess.Popen(
        [sys.executable, "-m", "tpu_paxos_torch", *args, "--device", DEV], cwd=here,
        env=_port_env(here), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        time.perf_counter()) for key, args in runs.items()}


def finish_tile_clis(goldens, script, started, tmp: str, card: str) -> None:
    """20c: each tiled CLI's summary, less the wall fields, against the
    JAX golden (fleet-quick's artifact bytes too)."""
    for key, (proc, t0) in started.items():
        stdout, stderr = proc.communicate(timeout=900)
        wall = time.perf_counter() - t0
        if key == "fleet":
            gold = goldens["search"]["fleet_quick"]
            got = _less_timing(json.loads(stdout.strip().splitlines()[-1]), SEARCH_TIMING)
            ok = (proc.returncode == 0 and got == gold["summary"]
                  and _file_sha256(os.path.join(tmp, gold["artifact"])) == gold["artifact_sha256"])
        else:
            gold = goldens["serve"]["cli"]["serve --fleet --lanes 8"]
            got = script.less_wall(json.loads(stdout.strip().splitlines()[-1]))
            ok = proc.returncode == gold["rc"] and got == gold["summary"]
        print(f"tiled CLI (20c) python -m tpu_paxos_torch {' '.join(proc.args[3:-2])}: "
              f"rc={proc.returncode} wall_s={wall:.3f} equal_to_golden={ok} | {card}")
        if not ok:
            print(stderr[-3000:], file=sys.stderr)
            raise SystemExit(f"the tiled {key} CLI disagrees with the JAX golden")


def run_tile(goldens, here: str, card: str, untiled_s: float | None = None) -> dict:
    """Phase 20: the lane tile on the card (20a, held beside phase 9's
    ``untiled_s``; 20b and 20c run in ``tests/test_torch_lane_tile_cuda.py``'s
    call, past this script's time)."""
    from tpu_paxos_torch.core import simkern as sk
    from tpu_paxos_torch.fleet import envelope
    from tpu_paxos_torch.parallel import mesh as pmesh

    t20 = time.perf_counter()
    envelope.clear_cache()
    mesh = pmesh.make_instance_mesh(TILE_RANKS, device=DEV)
    print(f"phase 20: the lane tile over {TILE_RANKS} ranks, threads of this process, all on "
          f"{torch.cuda.get_device_name(0)} (cuda:0) | {card}")
    out = {"fleet": run_tile_fleet(sk, goldens, mesh, card, untiled_s)}
    envelope.clear_cache()
    print(f"phase 20 (the lane tile) took {time.perf_counter() - t20:.1f} s")
    return out


#: the argument that makes this script a child comparing the host checks,
#: numpy against native, on arrays saved by :func:`start_native_compare`
NATIVE_FLAG = "--native-compare"
#: the argument that makes this script the child that runs phase 21
AUDIT_FLAG = "--phase-21"
#: the argument that makes this script the child that runs phase 22
LIBRARY_FLAG = "--phase-22"
#: this script, as its children run it
SCRIPT = os.path.abspath(__file__)
#: children started beside the phases (each with whether it has a session
#: of its own), stopped when the script exits
_STARTED: list = []
#: their directories (logs, the native compare's saved arrays), removed
#: when the script exits, whether it fails or not
_DIRS: list = []


def _spawn(args: list, logs: str, name: str, own_session: bool = True):
    """``python <args>`` from the checkout, its stdout and stderr in files
    of ``logs``.  In a session of its own by default, so that
    :func:`stop_children` stops it with all it started; without one it
    stays in this process's group and dies with it."""
    out, err = (open(os.path.join(logs, f"{name}.{x}"), "w") for x in ("out", "err"))
    here = os.path.dirname(os.path.abspath(__file__))
    with out, err:
        proc = subprocess.Popen([sys.executable, *args], cwd=here, env=_port_env(here),
                                stdout=out, stderr=err, start_new_session=own_session)
    _STARTED.append((proc, own_session))
    _DIRS.append(logs)
    return proc, logs, name, time.perf_counter()


def _finish(started, timeout: float) -> tuple:
    """Wait for a child of :func:`_spawn`: its exit code, stdout, stderr
    and the seconds since its start."""
    proc, logs, name, t0 = started
    rc = proc.wait(timeout=timeout)
    with open(os.path.join(logs, f"{name}.out")) as fo, open(os.path.join(logs, f"{name}.err")) as fe:
        return rc, fo.read(), fe.read(), time.perf_counter() - t0


def _join(started, what: str, timeout: float = 1200, hide: str | None = None) -> list:
    """Wait for a child of :func:`_spawn`, print its stdout (but the lines
    starting with ``hide``; its stderr to stderr) and return its stdout
    lines; its failure fails the script."""
    rc, out, err, wall = _finish(started, timeout)
    lines = out.splitlines()
    sys.stderr.write(err)
    print("\n".join(x for x in lines if hide is None or not x.startswith(hide)))
    print(f"{what} (child process) ended {wall:.1f} s after it started, rc={rc}")
    if rc != 0:
        raise SystemExit(f"{what} failed in its child process (exit {rc})")
    return lines


def stop_children() -> None:
    """Stop every child of :func:`_spawn`: a child in a session of its own
    with everything left in its group (its own processes, even after it
    has exited), any other child alone; then remove the children's
    directories."""
    for proc, own_session in _STARTED:
        if own_session:
            with contextlib.suppress(ProcessLookupError, PermissionError):
                os.killpg(proc.pid, signal.SIGKILL)
        elif proc.poll() is None:
            proc.kill()
        proc.wait()
    for path in _DIRS:
        shutil.rmtree(path, ignore_errors=True)


def start_native_compare(arrays: dict, stride: int, n_instances: int, label: str,
                         card: str):
    """Save a run's ``learned [I, A]``, ``chosen_vid`` and ``chosen_ballot``
    (host numpy) and start a child that times the host checks on them,
    numpy against ``tpu_paxos_torch.native`` (:func:`compare_native`)."""
    import numpy as np

    logs = tempfile.mkdtemp(prefix="chip_smoke_native_")
    for key, x in arrays.items():
        np.save(os.path.join(logs, f"{key}.npy"), np.ascontiguousarray(x))
    return _spawn([SCRIPT, NATIVE_FLAG, logs, str(stride), str(n_instances), card, label],
                  logs, "native")


def finish_native_compare(started) -> None:
    try:
        _join(started, f"native against numpy ({started[0].args[-1]})")
    finally:
        shutil.rmtree(started[1], ignore_errors=True)


def _verdict(fn) -> str:
    """``"ok"``, or the invariant a check names."""
    try:
        fn()
    except AssertionError as e:
        return f"{type(e).__name__}: {e}"
    return "ok"


def compare_native(learned, chosen_vid, chosen_ballot, stride: int, n_instances: int,
                   label: str, card: str) -> dict:
    """The host checks of one run, numpy against native: agreement and
    exactly-once (``harness/validate``, its numpy paths forced and then its
    native routing) and the decision log (``replay/decision_log``'s numpy
    renderer and ``native.render_decision_log``), each timed on the host.
    The verdicts and the log's sha256 must be equal."""
    from tpu_paxos_torch import native
    from tpu_paxos_torch.harness import validate
    from tpu_paxos_torch.replay.decision_log import decision_log

    native.load()
    routed = validate._NATIVE_MIN_CELLS
    out = {}
    for path, cells in (("numpy", 1 << 62), ("native", routed)):
        validate._NATIVE_MIN_CELLS = cells
        try:
            t0 = time.perf_counter()
            v = (_verdict(lambda: validate.check_agreement(learned)),
                 _verdict(lambda: validate.check_exactly_once(learned)))
            out[path] = {"validate_s": time.perf_counter() - t0, "verdicts": v}
        finally:
            validate._NATIVE_MIN_CELLS = routed
    t0 = time.perf_counter()
    log = decision_log(chosen_vid, chosen_ballot, stride, n_instances)
    out["numpy"]["log_s"] = time.perf_counter() - t0
    out["numpy"]["sha"] = hashlib.sha256(log.encode()).hexdigest()
    del log
    t0 = time.perf_counter()
    log = native.render_decision_log(chosen_vid, chosen_ballot, stride, n_instances)
    out["native"]["log_s"] = time.perf_counter() - t0
    out["native"]["sha"] = hashlib.sha256(log.encode()).hexdigest()
    del log
    npy, nat = out["numpy"], out["native"]
    print(f"host checks ({label}, learned {list(learned.shape)}): validation numpy "
          f"{npy['validate_s']:.3f} s native {nat['validate_s']:.3f} s verdicts "
          f"{list(nat['verdicts'])} equal={npy['verdicts'] == nat['verdicts']}; decision log "
          f"({int((chosen_vid != -1).sum())} lines) numpy {npy['log_s']:.3f} s native "
          f"{nat['log_s']:.3f} s sha256 {nat['sha'][:16]} equal={npy['sha'] == nat['sha']} "
          f"| {card}")
    if npy["verdicts"] != nat["verdicts"] or npy["sha"] != nat["sha"]:
        raise SystemExit(f"native and numpy host checks disagree ({label}): {out}")
    return out


def run_native_child(argv: list) -> int:
    """The :data:`NATIVE_FLAG` child: :func:`compare_native` on the saved
    arrays."""
    import numpy as np

    logs, stride, n_instances, card, label = argv
    arrays = {k: np.load(os.path.join(logs, f"{k}.npy"))
              for k in ("learned", "chosen_vid", "chosen_ballot")}
    compare_native(arrays["learned"], arrays["chosen_vid"], arrays["chosen_ballot"],
                   int(stride), int(n_instances), label, card)
    return 0


def run_audit_phase(card: str) -> dict:
    """Phase 21: ``audit --device cuda`` over every registered entry: the
    kernel launches a round equal the kernel calls a round pinned on the
    CPU, and the syncs and collectives a round hold to the budget."""
    from tpu_paxos_torch.analysis import audit

    t21 = time.perf_counter()
    report = audit.run_audit(device=DEV)
    pinned = audit.load_budget()["entries"]
    equal = True
    for name, m in sorted(report["entries"].items()):
        pr = m["per_round"]
        la = pr["launches"]
        same = all(m["launches"][k] == pinned[name][k] for k in audit.KERNELS)
        equal = equal and same
        print(f"audit {name}: {m['rounds']} rounds; a round: launches store_accepts="
              f"{la['store_accepts']:g} accum_acks={la['accum_acks']:g} windows="
              f"{la['steady_state_windows']:g} (= the CPU-pinned calls: {same}), syncs "
              f"{pr['syncs']:g} ({m['syncs']} in all), collectives {pr['collectives']:g}, host "
              f"reads {pr['host_reads']:g}; {m['seconds']:.3f} s | {card}")
    for p in report["sweep"]:
        print(f"audit sweep: {p['detail']}")
    for v in report["budget"]["violations"]:
        print(f"audit budget {v['rule']}: {v['detail']}")
    for name in report["budget"]["stale"]:
        print(f"audit budget: stale entry {name}")
    print(f"phase 21 (the audit on the card, {len(report['entries'])} entries) took "
          f"{time.perf_counter() - t21:.1f} s | {card}")
    if not report["ok"] or not equal:
        raise SystemExit("phase 21: the audit on the card failed")
    return report


#: 22a's turns, each one bench_sim run traced and one untraced, after the
#: process's first run (untraced, cold, left out of the ratios)
PROFILE_TURNS = 2


def run_traced_bench(sk, goldens, card: str) -> None:
    """22a: bench_sim untraced, then :data:`PROFILE_TURNS` turns of a run
    under ``utils/log.profile_trace`` and one without: the decision log
    equals phase 1's golden every time, the trace's kernel events equal the
    launch counters, and ``rounds_to_chosen`` and three ``value_status``
    answers equal JAX's (``library.bench_sim``)."""
    from tpu_paxos_torch.core import sim
    from tpu_paxos_torch.utils import log as logm

    gold, lib = goldens["bench_sim"], goldens["library"]["bench_sim"]
    cfg = _bench_cfg(gold)
    kernels = ("store_accepts", "accum_acks")

    def timed(out_dir=None):
        """One run, traced into ``out_dir`` if given: its seconds, its
        result and its launches."""
        sk.reset_counts()
        torch.cuda.synchronize()
        with logm.profile_trace(out_dir, DEV):
            t0 = time.perf_counter()
            res = sim.run(cfg, device=DEV)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _check_bench_sim(res, cfg, gold)
        return wall, res, dict(sk.LAUNCHES)

    first_s, _, want = timed()
    turns, agree = [], True
    for _ in range(PROFILE_TURNS):
        with tempfile.TemporaryDirectory() as d:
            traced_s, res, launches = timed(d)
            path = os.path.join(d, logm.TRACE_FILE)
            counts = logm.trace_kernel_counts(path, [f"{k}_kernel" for k in kernels])
            events = {k: counts[f"{k}_kernel"] for k in kernels}
            mb = os.path.getsize(path) / 1e6
        plain_s, _, again = timed()
        agree = agree and events == {k: launches[k] for k in kernels} and \
            launches == want == again
        turns.append((traced_s, plain_s))
    ms = [(1e3 * t / res.rounds, 1e3 * u / res.rounds) for t, u in turns]
    ratios = [t / u for t, u in turns]
    rtc = sim.rounds_to_chosen_digest(res.rounds_to_chosen)
    status = [[v, res.value_status(v)] for v, _ in lib["value_status"]]
    print(f"traced bench_sim (22a, I={cfg.n_instances}): rounds={res.rounds} decision log = "
          f"phase 1's golden on all {1 + 2 * PROFILE_TURNS} runs, trace {mb:.1f} MB, kernel "
          f"events {json.dumps(events, sort_keys=True)} launches "
          f"{json.dumps(launches, sort_keys=True)} (untraced {json.dumps(want, sort_keys=True)})"
          f" | {card}")
    print(f"profiler cost on bench_sim (22a): the process's first run, untraced "
          f"{1e3 * first_s / res.rounds:.3f} ms a round (left out); turns traced, untraced "
          f"{', '.join(f'{t:.3f} / {u:.3f}' for t, u in ms)} ms a round; traced/untraced "
          f"{', '.join(f'{r:.3f}' for r in ratios)} (spread {min(ratios):.3f}-"
          f"{max(ratios):.3f}) | {card}")
    print(f"rounds_to_chosen (22a): {json.dumps(rtc, sort_keys=True)}; value_status "
          f"{json.dumps(status)}")
    if not agree:
        raise SystemExit("22a: the trace's kernel events disagree with the launch counters")
    if rtc != lib["rounds_to_chosen"] or json.loads(json.dumps(status)) != lib["value_status"]:
        raise SystemExit("22a: rounds_to_chosen or value_status disagrees with JAX's golden")


def run_traced_fast(goldens, card: str) -> None:
    """22b: the fast path's headline (16 windows of 2**27) under
    ``profile_trace`` (one ``window_kernel`` event a window, equal to the
    launch counter), and the fast CLI at 2**23 with ``--trace-dir``
    (stdout the untraced golden's)."""
    from tpu_paxos_torch import __main__ as cli
    from tpu_paxos_torch.core import fast
    from tpu_paxos_torch.core import fastwin as fw
    from tpu_paxos_torch.utils import log as logm

    with tempfile.TemporaryDirectory() as d:
        st = fast.init_state(I_FW, A, device=DEV)
        fw.reset_counts()
        with logm.profile_trace(d, DEV):
            t0 = time.perf_counter()
            st, counts = fw.steady_state_windows_fused(st, None, reps=WINDOWS, quorum=3,
                                                        iota_vids=True)
            total = int(counts.cpu().to(torch.int64).sum())
            wall = time.perf_counter() - t0
        launches = fw.LAUNCHES["steady_state_windows"]
        events = logm.trace_kernel_counts(os.path.join(d, logm.TRACE_FILE),
                                          ["window_kernel"])["window_kernel"]
        del st, counts
        torch.cuda.empty_cache()
    print(f"traced fast headline (22b, A={A}, I={I_FW}, {WINDOWS} windows): total={total} "
          f"window_kernel events={events} launches={launches} wall_s={wall:.4f} | {card}")
    if not events == launches == WINDOWS or total != WINDOWS * I_FW:
        raise SystemExit(f"22b: {events} kernel events, {launches} launches, want {WINDOWS}")
    gold = goldens["fast_cli_2p23"]
    with tempfile.TemporaryDirectory() as d:
        argv = list(gold["args"]) + [f"--device={DEV}", "--trace-dir", d]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        n = sum(logm.trace_kernel_counts(os.path.join(d, logm.TRACE_FILE)).values())
    print(f"traced fast cli (22b) {' '.join(gold['args'])} --trace-dir: rc={rc} kernel events={n} "
          f"stdout equal to the untraced golden={buf.getvalue() == gold['stdout']}")
    if rc != 0 or buf.getvalue() != gold["stdout"]:
        raise SystemExit("22b: the traced fast CLI's stdout differs from the untraced run's")


def run_equivalent(goldens, card: str) -> None:
    """22c: ``run_equivalent_sim(4, 4, 10)`` on the card at seeds 0-2:
    rounds and every SimResult array equal JAX's, and the reference's
    checker holds."""
    import numpy as np

    from tpu_paxos_torch.harness import reference_runner as refr
    from tpu_paxos_torch.harness import validate

    gold = goldens["library"]["equivalent_sim"]
    for seed in gold["seeds"]:
        t0 = time.perf_counter()
        res, in_order = refr.run_equivalent_sim(*gold["args"], seed=seed, device=DEV)
        wall = time.perf_counter() - t0
        want = gold["runs"][str(seed)]
        got = {f: hashlib.sha256(np.ascontiguousarray(np.asarray(getattr(res, f)), dtype="<i4")
                                 .tobytes()).hexdigest() for f in want["arrays"]}
        seqs = validate.check_all(res.learned, res.expected_vids)
        validate.check_in_order_clients(seqs[0], in_order)
        same = (res.rounds, res.done, got) == (want["rounds"], want["done"], want["arrays"])
        print(f"equivalent sim (22c) 4 4 10 seed {seed}: rounds={res.rounds} wall_s={wall:.3f} "
              f"arrays equal to JAX's={same}; check_all, check_in_order_clients hold | {card}")
        if not same:
            raise SystemExit(f"22c: run_equivalent_sim seed {seed} disagrees with JAX's golden")


#: phase 22's processes running at once (the parent's phases share the host)
LIBRARY_PROCS = 2


def run_library_phase(goldens, card: str) -> None:
    """Phase 22: the library surface on the card.  22a-c in this process,
    then 22d-f as processes of their own, :data:`LIBRARY_PROCS` at a
    time."""
    from tpu_paxos_torch.core import simkern as sk
    from tpu_paxos_torch.examples import TWINS

    t22 = time.perf_counter()
    run_traced_bench(sk, goldens, card)
    run_traced_fast(goldens, card)
    run_equivalent(goldens, card)
    todo = [(f"example {n}", ["-m", f"tpu_paxos_torch.examples.{n}", "--device", DEV])
            for n in TWINS]
    todo += [("replay diff", ["scripts/torch_replay_diff_member.py", "--device", DEV]),
             ("check smoke", ["scripts/torch_check_smoke.py", "--device", DEV])]
    logs = tempfile.mkdtemp(prefix="chip_smoke_22_")
    running, failed = [], []
    while todo or running:
        while todo and len(running) < LIBRARY_PROCS:
            what, args = todo.pop(0)
            # in this process's group: stopping this child stops them too
            running.append((what, _spawn(args, logs, what.replace(" ", "_"), own_session=False)))
        what, started = running.pop(0)
        rc, out, err, wall = _finish(started, timeout=600)
        if what.startswith("example "):
            name = what.split()[1]
            ok = rc == 0 and out == goldens["library"]["examples"][TWINS[name]]
            label = f"example (22d) {name}: JAX twin's lines={ok}"
        elif what == "replay diff":
            ok = rc == 0 and json.loads(out.splitlines()[-1])["replay_diff_member"]
            label = f"replay diff (22e): {out.strip()}"
        else:
            ok = rc == 0 and json.loads(out.splitlines()[-1])["check_smoke"]
            label = "check smoke (22f, CUDA_LAUNCH_BLOCKING=1 against normal):\n" + out.rstrip()
        print(f"{label}; rc={rc}, ended within {wall:.1f} s of its start | {card}")
        if not ok:
            sys.stderr.write(err[-3000:])
            failed.append(what)
    print(f"phase 22 (the library surface) took {time.perf_counter() - t22:.1f} s | {card}")
    if failed:
        raise SystemExit(f"phase 22 failed: {', '.join(failed)}")


#: the argument that makes this script the child that runs phases 17, 18,
#: 14 and 16
MC_FLAG = "--phases-17-18-14-16"
#: the argument that makes this script the child that runs phases 7, 8,
#: 10, 13 and 15
SERVE_FLAG = "--phases-7-8-10-13-15"
#: a child's last line: its results, as JSON, after this prefix
CHILD_RESULT = "child result: "


def _read(r: dict) -> dict:
    """What the kernels line reads of a phase's record."""
    return {k: r[k] for k in ("launches", "checked")}


def run_mc_lane(goldens, here: str, card: str) -> dict:
    """The :data:`MC_FLAG` child's part: phases 17, 18, 14 and 16, and what
    the kernels line reads of them."""
    mc = run_mc(goldens, here, card)
    evolve = run_evolve(goldens, here, card)
    run_member(goldens, here, card)
    control = run_control(goldens, here, card)
    return {"mc": {"scopes": _read(mc["scopes"])}, "evolve": _read(evolve),
            "control": {k: _read(control[k]) for k in ("full", "fleet")}}


def run_search_phase(sk, goldens, here: str, card: str) -> tuple:
    """Phase 13: the stress fleet sweep beside fleet-quick's subprocess,
    the wide search and the padded envelope."""
    t13 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # 13a's subprocess runs beside 13c's
        quick = start_fleet_quick(goldens, here, tmp)
        run_stress_fleet(goldens, card)
        run_fleet_quick(goldens, here, card, quick, tmp)
    wide = run_search_wide(sk, goldens, card)
    env13 = run_envelope(sk, goldens, card)
    print(f"phase 13 (search, fleet sweep, padded envelope) took {time.perf_counter() - t13:.1f} s")
    return wide, env13


def run_serve_lane(goldens, here: str, card: str) -> dict:
    """The :data:`SERVE_FLAG` child's part: phases 7, 8, 10, 13 and 15, and
    what the kernels line reads of them."""
    from tpu_paxos_torch.core import simkern as sk

    run_fast_cli(goldens)
    for key in ("bench_sim_partition_flap", "bench_sim_wan3"):
        run_scheduled(sk, goldens, key)
    full = run_runtime_full(sk, goldens)
    wide, env13 = run_search_phase(sk, goldens, here, card)
    serve = run_serve(goldens, here, card)
    return {"full": full, "wide": {"launches": wide["launches"]}, "envelope": _read(env13),
            "serve": {k: _read(serve[k]) for k in ("full", "fleet")}}


def finish_child_phases(started, what: str) -> dict:
    """Wait for a child of :data:`MC_FLAG` or :data:`SERVE_FLAG`, print its
    lines and return its results; its failure fails the script."""
    lines = _join(started, what, hide=CHILD_RESULT)
    results = [x for x in lines if x.startswith(CHILD_RESULT)]
    if not results:
        raise SystemExit(f"{what} printed no result in their child process")
    return json.loads(results[-1][len(CHILD_RESULT):])


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    if sys.argv[1:2] == [NATIVE_FLAG]:
        # host work only: the parent has checked the card
        sys.path.insert(0, here)
        return run_native_child(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, here)
    from tpu_paxos_torch.core import fast
    from tpu_paxos_torch.core import fastwin as fw
    from tpu_paxos_torch.core import simkern as sk
    from tpu_paxos_torch.utils import kbuild

    with open(os.path.join(here, "tpu_paxos_torch", "data", "goldens.json")) as fh:
        goldens = json.load(fh)
    card = _card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")
    t0 = time.perf_counter()
    libs = kbuild.build_all([sk.NAME, fw.NAME])
    sk.load()
    fw.load()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s -> "
          f"{sorted(os.path.relpath(p, here) for p in libs.values())}")
    for flag, phases in ((MC_FLAG, run_mc_lane), (SERVE_FLAG, run_serve_lane)):
        if flag in sys.argv[1:]:
            out = phases(goldens, here, card)
            print(CHILD_RESULT + json.dumps(out, default=lambda x: x.item()))
            return 0
    if AUDIT_FLAG in sys.argv[1:]:
        run_audit_phase(card)
        return 0
    if LIBRARY_FLAG in sys.argv[1:]:
        run_library_phase(goldens, card)
        return 0

    rec = check_kernels(sk)
    print(f"kernels: {json.dumps(list(rec))}")
    launches, native_main = run_main_path(sk, goldens)
    snaps = snapshot_main_path(sk, goldens, launches)
    main_rec = time_main_path_operands(sk, snaps)
    del snaps
    torch.cuda.empty_cache()
    run_cli(sk, goldens)
    fw_rec = check_fastwin(fw, fast)
    fw_launches = run_fast_headline(fw, fast, card)
    # the kernels' own times are taken by now: from here on the phases run
    # in four lanes, this process (9, 19, 11, 12, 20) and two children
    # (17, 18, 14, 16 and 7, 8, 10, 13, 15), with phases 21 and 22 in
    # children of their own (each child's sync count is its own: the
    # debug mode is per process); 19b's host checks run in a child beside
    # them
    logs = tempfile.mkdtemp(prefix="chip_smoke_child_")
    mc_child = _spawn([SCRIPT, MC_FLAG], logs, "mc")
    serve_child = _spawn([SCRIPT, SERVE_FLAG], logs, "serve")
    audit21 = _spawn([SCRIPT, AUDIT_FLAG], logs, "audit")
    library22 = _spawn([SCRIPT, LIBRARY_FLAG], logs, "library")
    try:
        fleet = run_fleet(sk, goldens, card)
        shard = run_sharded(goldens, here, card)
        t11 = time.perf_counter()
        run_stress_quick(goldens, here, card)
        wedge = run_triage_wedge(sk, goldens, here, card)
        with tempfile.TemporaryDirectory() as keep:
            full_art = run_triage_full(sk, goldens, here, card, keep)
            print(f"phase 11 (triage, 11c's replay in 12d) took {time.perf_counter() - t11:.1f} s")
            t12 = time.perf_counter()
            tele = run_telemetry_single(sk, goldens, card)
            tele_fleet = run_telemetry_fleet(sk, goldens, card)
            data = os.path.join(here, "tpu_paxos_torch", "data")
            paths = {name: os.path.join(data, name)
                     for name in ("repro_culprit.json", "repro_takeover.json")}
            paths[goldens["triage_full"]["artifact"]] = full_art["path"]
            # 11c's replay runs beside 12d's traces: neither writes the artifact
            replay_full = _replay(here, full_art["path"], goldens["triage_full"], {},
                                  full_art["label"])
            try:
                run_trace_cli(goldens, here, paths, card)
            finally:
                replay_full()
            print(f"phase 12 (flight recorder, with 11c's replay) took "
                  f"{time.perf_counter() - t12:.1f} s")
        tile = run_tile(goldens, here, card, fleet["headline"]["checked_seconds"])
        _join(audit21, "phase 21")
        _join(library22, "phase 22")
        mc_lane = finish_child_phases(mc_child, "phases 17, 18, 14, 16")
        serve_lane = finish_child_phases(serve_child, "phases 7, 8, 10, 13, 15")
    finally:
        # on a failure the script's exit stops the children (stop_children)
        shutil.rmtree(logs, ignore_errors=True)
    mc, evolve, control = mc_lane["mc"], mc_lane["evolve"], mc_lane["control"]
    full, wide, env13 = serve_lane["full"], serve_lane["wide"], serve_lane["envelope"]
    serve = serve_lane["serve"]
    finish_native_compare(native_main)
    finish_native_compare(shard["fast"]["native"])

    replaces = {
        "simkern.store_accepts": ("store_accepts", "tpu_paxos/core/simkern.py:99"),
        "simkern.accum_acks": ("accum_acks", "tpu_paxos/core/simkern.py:160"),
    }
    kernels = []
    for name, r in rec.items():
        key, where = replaces[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "tpu_paxos_torch/csrc/simkern.cu",
            "replaces": where,
            "launches": launches[key],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": max(r["bytes_ms"], r["ops_ms"]),
            "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
            "library_ms": None,
            "main_path_ms": main_rec[name]["main_path_ms"],
            "main_path_bound_ms": main_rec[name]["main_path_bound_ms"],
            "fleet_lanes": fleet["checked"][name]["lanes"][0],
            "fleet_launches": fleet["headline"]["launches"][key],
            "fleet_ms": fleet["checked"][name]["ms"],
            "fleet_bound_ms": fleet["checked"][name]["bound_ms"],
            "fleet_full_launches": full[name]["launches"],
            "fleet_full_ms": full[name]["ms"],
            "fleet_full_bound_ms": full[name]["bound_ms"],
            "triage_lanes": wedge["checked"][name]["lanes"][0],
            "triage_launches": wedge["culprit"]["launches"][key],
            "triage_ms": wedge["checked"][name]["ms"],
            "triage_bound_ms": wedge["checked"][name]["bound_ms"],
            "armed_launches": tele["launches"]["bench_sim"][key],
            "armed_ms": tele["checked"][name]["ms"],
            "armed_bound_ms": tele["checked"][name]["bound_ms"],
            "armed_fleet_launches": tele_fleet["launches"][key],
            "search_launches": wide["launches"][key],
            "envelope_launches": env13["launches"][key],
            "envelope_lanes": env13["checked"][name]["lanes"][0],
            "envelope_ms": env13["checked"][name]["ms"],
            "envelope_bound_ms": env13["checked"][name]["bound_ms"],
            "serve_launches": serve["full"]["launches"][key],
            "serve_lanes": serve["full"]["checked"][name]["lanes"][0],
            "serve_checked": serve["full"]["checked"][name]["launches"],
            "serve_ms": serve["full"]["checked"][name]["ms"],
            "serve_bound_ms": serve["full"]["checked"][name]["bound_ms"],
            "serve_fleet_launches": serve["fleet"]["launches"][key],
            "serve_fleet_lanes": serve["fleet"]["checked"][name]["lanes"][0],
            "serve_fleet_checked": serve["fleet"]["checked"][name]["launches"],
            "serve_fleet_ms": serve["fleet"]["checked"][name]["ms"],
            "serve_fleet_bound_ms": serve["fleet"]["checked"][name]["bound_ms"],
            "control_launches": control["full"]["launches"][key],
            "control_lanes": control["full"]["checked"][name]["lanes"][0],
            "control_checked": control["full"]["checked"][name]["launches"],
            "control_ms": control["full"]["checked"][name]["ms"],
            "control_bound_ms": control["full"]["checked"][name]["bound_ms"],
            "control_fleet_launches": control["fleet"]["launches"][key],
            "control_fleet_lanes": control["fleet"]["checked"][name]["lanes"][0],
            "control_fleet_checked": control["fleet"]["checked"][name]["launches"],
            "control_fleet_ms": control["fleet"]["checked"][name]["ms"],
            "control_fleet_bound_ms": control["fleet"]["checked"][name]["bound_ms"],
            "mc_launches": mc["scopes"]["launches"][key],
            "mc_lanes": mc["scopes"]["checked"][name]["lanes"][0],
            "mc_checked": mc["scopes"]["checked"][name]["launches"],
            "mc_ms": mc["scopes"]["checked"][name]["ms"],
            "mc_bound_ms": mc["scopes"]["checked"][name]["bound_ms"],
            "evolve_launches": evolve["launches"][key],
            "evolve_lanes": evolve["checked"][name]["lanes"],
            "evolve_checked": evolve["checked"][name]["launches"],
            "evolve_ms": evolve["checked"][name]["ms"],
            "evolve_bound_ms": evolve["checked"][name]["bound_ms"],
            "sharded_launches_per_rank": [n[key] for n in shard["sim"]["launches"]],
            "sharded_checked": shard["sim"]["checked"][name]["launches"],
            "sharded_ms": shard["sim"]["checked"][name]["ms"],
            "sharded_bound_ms": shard["sim"]["checked"][name]["bound_ms"],
            "tile_launches_per_rank": [n[key] for n in tile["fleet"]["launches"]],
            "tile_checked": tile["fleet"]["checked"][name]["launches"],
            "tile_ms": tile["fleet"]["checked"][name]["ms"],
            "tile_bound_ms": tile["fleet"]["checked"][name]["bound_ms"],
        })
    r = fw_rec["iota"]  # the headline run's variant
    kernels.append({
        "name": "fastwin.steady_state_windows",
        "route": "cuda",
        "source": "tpu_paxos_torch/csrc/fastwin.cu",
        "replaces": "tpu_paxos/core/fastwin.py:131",
        "launches": fw_launches,
        "max_abs_err": fw_rec["max_abs_err"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": max(r["bytes_ms"], r["ops_ms"]),
        "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
        "library_ms": None,
    })
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s (phases 1-22)")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        stop_children()
    sys.exit(code)
