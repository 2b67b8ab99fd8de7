# Analog of the reference's shell-script surface (ref multi/run.sh,
# multi/val.sh, member/diff.sh): run, bench, parity-vs-C++, replay-diff,
# and a sanitizer-mode pass (check, the val.sh analog).

PY ?= python

.PHONY: test test-slow check lint lint-json audit audit-json \
	shard-audit bench bench-sharded parity parity-fast replay-diff \
	replay-diff-member parity-torch parity-fast-torch \
	replay-diff-member-torch check-smoke-torch run stress stress-quick fleet fleet-quick \
	evolve evolve-quick mc mc-quick serve serve-quick serve-fleet \
	serve-fleet-quick serve-control serve-control-quick \
	envelope-quick clean

# Fast tier: every feature covered, heavy literal-size / long-schedule
# variants deselected (marked slow).  ~6 min; test-slow runs everything.
test:
	$(PY) -m pytest tests/ -x -q -m "not slow"

test-slow:
	$(PY) -m pytest tests/ -x -q

# paxlint: determinism & JAX-purity static analysis
# (tpu_paxos/analysis/).  Pure-AST — runs without jax, in seconds.
# Exit 0 iff zero unsuppressed findings and no stale baseline entries.
lint:
	$(PY) -m tpu_paxos lint

lint-json:
	$(PY) -m tpu_paxos lint --json

# jaxpr-audit: trace-time IR contracts (IR201-IR205) + pinned op/cost
# budget over the registered entry points of both engines and the
# sharded path (tpu_paxos/analysis/jaxpr_audit.py), PLUS the
# compiled-artifact tier (--hlo, tpu_paxos/analysis/hlo_audit.py):
# normalized-HLO goldens for the hot kernels, per-primitive
# instruction budgets + memory ceilings, and the donation/aliasing
# checker.  Traces on CPU — ops counts are backend-independent; the
# HLO pins are backend-gated AND compiled under the repo's canonical
# CPU environment: the 8-virtual-device mesh tests/conftest.py
# provisions (XLA's CPU backend partitions fusions differently per
# device count, so the goldens only reproduce under the same count —
# tests/test_hlo_audit.py enforces the committed pins from inside
# that mesh).  Re-pin after intentional program growth:
# TPU_PAXOS_OP_BUDGET_PIN=1 make audit (jaxpr tier) /
# TPU_PAXOS_HLO_PIN=1 make audit (HLO goldens + budget).
AUDIT_ENV = JAX_PLATFORMS=cpu \
	XLA_FLAGS="$(XLA_FLAGS) --xla_force_host_platform_device_count=8"

audit:
	$(AUDIT_ENV) $(PY) -m tpu_paxos audit --hlo

audit-json:
	$(AUDIT_ENV) $(PY) -m tpu_paxos audit --hlo --json

# shard-audit: mesh-polymorphic SPMD contracts
# (tpu_paxos/analysis/shard_audit.py) — partition-rule coverage
# (SH301), per-mesh replication ceilings + collective census
# (SH302/SH303, analysis/shard_budget.json), and cross-mesh parity
# certificates (SH304, analysis/shard_certificate.json) over the
# virtual {1,2,4,8} mesh grid the AUDIT_ENV provisions.  Re-pin:
# TPU_PAXOS_SHARD_PIN=1 make shard-audit (certificate) /
# TPU_PAXOS_SHARD_BUDGET_PIN=1 make shard-audit (budget).
shard-audit:
	$(AUDIT_ENV) $(PY) -m tpu_paxos audit --shard-only

# Sanitizer pass (ref multi/val.sh runs the suite under valgrind): the
# static analyzers first (cheapest signal), then the quick-scope model
# check (protocol-level gate; the full scope stays out of the fast
# path — make mc), then the fast tier with NaN-checking on, then an
# un-jitted op-by-op smoke of one tiny config per engine (every cond
# predicate, slice bound, and dtype materializes eagerly).  The pallas
# interpreter path is part of the fast tier (tests/test_fastwin.py).
check: lint audit shard-audit mc-quick evolve-quick envelope-quick serve-quick serve-fleet-quick serve-control-quick
	JAX_DEBUG_NANS=1 $(PY) -m pytest tests/ -x -q -m "not slow"
	JAX_DISABLE_JIT=1 JAX_DEBUG_NANS=1 $(PY) scripts/check_smoke.py

bench:
	$(PY) bench.py

bench-sharded:
	TPU_PAXOS_BENCH_SHARDED=1 $(PY) bench.py

# Full-speed parity anchor: the canonical debug.conf.sample line on the
# C++ reference (~50s wall clock — its delays are real milliseconds),
# then the tpu_paxos equivalent, both judged by the same invariants.
parity:
	$(PY) -c "import json; from tpu_paxos.harness import reference_runner as r; \
	print(json.dumps(r.check_parity(reference_args_list=r.reference_args(), timeout=600), indent=2))"

# Time-scaled parity anchor (seconds instead of ~50s; fault rates identical).
parity-fast:
	$(PY) -c "import json; from tpu_paxos.harness import reference_runner as r; \
	print(json.dumps(r.check_parity(), indent=2))"

# Same-seed reruns produce byte-identical decision logs (spirit of
# ref member/diff.sh).
replay-diff:
	$(PY) -m pytest tests/test_replay.py -x -q

# Record/replay for a wall-clock-paced membership driver: the host's
# injection schedule is the one nondeterministic input; record it,
# replay it, byte-compare decision logs (ref member/run.sh:10-16,
# member/diff.sh:1-3 — the Indet subsystem's workflow).
replay-diff-member:
	$(PY) scripts/replay_diff_member.py

# The same four surfaces on the PyTorch port (tpu_paxos_torch), on the
# card unless DEVICE=cpu: the parity anchor against the C++ reference,
# the wall-paced member record/replay diff, and the strict-mode smoke of
# one tiny config per engine (CUDA_LAUNCH_BLOCKING=1 against a normal run).
DEVICE ?= cuda

parity-torch:
	$(PY) -c "import json; from tpu_paxos_torch.harness import reference_runner as r; \
	print(json.dumps(r.check_parity(reference_args_list=r.reference_args(), timeout=600, device='$(DEVICE)'), indent=2))"

parity-fast-torch:
	$(PY) -c "import json; from tpu_paxos_torch.harness import reference_runner as r; \
	print(json.dumps(r.check_parity(device='$(DEVICE)'), indent=2))"

replay-diff-member-torch:
	$(PY) scripts/torch_replay_diff_member.py --device $(DEVICE)

check-smoke-torch:
	$(PY) scripts/torch_check_smoke.py --device $(DEVICE)

# Randomized sweep: seeds x fault mixes through the general engine,
# full invariant suite on every run (the reference's stated purpose,
# beyond the fixed-seed tests).  SEEDS=n overrides seeds per mix.
# Failing seeds are shrunk to minimal repro artifacts under
# stress-triage/ (`python -m tpu_paxos repro <artifact>` replays them).
stress:
	$(PY) -m tpu_paxos.harness.stress --seeds $(or $(SEEDS),8) --sharded \
	  --triage-dir stress-triage

# Quick pass: 2 seeds x every mix (incl. the correlated-fault episode
# mixes: partition-flap, one-way, pause-heavy, pause-crash).
stress-quick:
	$(PY) -m tpu_paxos.harness.stress --seeds 2 --triage-dir stress-triage

# Fleet schedule search: sample episode schedules from the seeded
# grammar, run them as device-batched lanes (one XLA dispatch per
# generation), shrink every wedge to a repro artifact under
# stress-triage/.  LANES=n / GENS=n override the budget.
fleet:
	$(PY) -m tpu_paxos fleet --lanes $(or $(LANES),8) \
	  --generations $(or $(GENS),4) --triage-dir stress-triage

# Quick pass with the synthetic decision_round_max wedge knob armed:
# slow-converging schedules count as wedges, so the find -> shrink ->
# artifact -> `python -m tpu_paxos repro` path is exercised end to end
# in one short run.
fleet-quick:
	$(PY) -m tpu_paxos fleet --lanes 8 --generations 1 --seed 2 \
	  --decision-round-max 35 --max-wedges 1 --triage-dir stress-triage

# Certified selection loop (tpu_paxos/fleet/evolve.py): mutate-and-
# select over fault-schedule / churn / offered-load genomes, one
# fleet dispatch per generation through the shared envelope cache
# (zero warm compiles after gen 0, census-pinned).  --certified reads
# the lane budget from the mc certificate (quick scope / 4) and
# withholds the bench record unless the shrunk artifact replays
# byte-identically inside it.  AXIS=fleet|member|serve, HUNT=<cause>.
evolve:
	$(PY) -m tpu_paxos evolve --axis $(or $(AXIS),fleet) \
	  --lanes $(or $(LANES),8) --generations $(or $(GENS),8) \
	  $(if $(HUNT),--hunt $(HUNT)) --triage-dir stress-triage

# Quick pass (wired into make check): the synthetic
# decision_round_max wedge knob armed, so sample -> select -> flag ->
# shrink -> artifact -> replay is exercised end to end in one short
# run (same knob and seed discipline as fleet-quick).
evolve-quick:
	$(PY) -m tpu_paxos evolve --lanes 8 --generations 2 --seed 2 \
	  --decision-round-max 35 --max-wedges 1 --triage-dir stress-triage

# Exhaustive bounded model checking (tpu_paxos/analysis/modelcheck.py):
# enumerate EVERY fault scenario of the declared scope — episode kinds
# x quantized intervals x node groups x rate tiers x knob tiers x
# gate tiers x seeds, node-permutation symmetry reduced — as chunked
# device-batched fleet lanes, shrink any counterexample to an
# mc_scenario_<index> repro artifact, and gate on the pinned scope
# certificate (analysis/mc_certificate.json).  Re-pin after an
# intentional scope/engine change: TPU_PAXOS_MC_PIN=1 make mc (and
# the same for mc-quick).
mc:
	$(PY) -m tpu_paxos mc --scope full --triage-dir stress-triage

# All four committed scopes in ONE process: gray shares quick's
# engine envelope so its chunks ride quick's compile; churn and
# control certify the membership fleet and the admission controller's
# policy contracts (~60s cold on cpu, dominated by the three engine
# compiles).
mc-quick:
	$(PY) -m tpu_paxos mc --scope quick,gray,churn,control --triage-dir stress-triage

# Geometry-padded envelope smoke (wired into make check): ONE padded
# fleet executable must serve the whole (geometry x protocol-knob x
# rate) grid — the fast-tier collapse cell dispatches an 8-cell grid
# through one cached runner and pins a ZERO warm-compile census after
# the first dispatch, plus cache-identity across geometries.
# Decision-log parity and the named-rejection surface ride the same
# module's other fast cells (and the tier-1 run).
envelope-quick:
	JAX_PLATFORMS=cpu $(PY) -m pytest \
	  tests/test_envelope_pad.py::test_envelope_compile_collapse -x -q

# Open-loop serving (tpu_paxos/serve/): Poisson arrivals at an
# offered rate (values per 1000 rounds) admitted mid-flight through
# double-buffered dispatch windows; prints the latency-at-load sweep
# + knee judgment.  RATE=milli / VALUES=n override the sweep shape;
# add --sequential via SERVE_FLAGS for the naive-dispatch baseline.
SERVE_RATES ?= 1000,2000,4000,8000,16000,32000
serve:
	$(PY) -m tpu_paxos serve --values $(or $(VALUES),512) \
	  --sweep $(SERVE_RATES) \
	  --drop-rate 500 --dup-rate 1000 --max-delay 2 $(SERVE_FLAGS)

# Quick pass (wired into make check): a small Poisson run at a
# sustained rate plus the zero-load limit; exits non-zero if the
# stream does not drain.
serve-quick:
	$(PY) -m tpu_paxos serve --values 64 --rate-milli 4000 \
	  --drop-rate 500 --dup-rate 1000 --max-delay 2
	$(PY) -m tpu_paxos serve --values 64 --rate-milli 0

# Fleet serving (tpu_paxos/serve/fleet.py): many tenant streams per
# dispatch — the serve window vmapped over [lanes] with on-device
# per-lane SLO verdicts; prints the (lanes x rates) aggregate
# sustained-values/sec + knee SURFACE.  SERVE_LANES=l,l,... /
# VALUES=n override (a ?= variable like SERVE_RATES: commas inside
# $(or ...) would split into separate arguments).
SERVE_LANES ?= 1,2,4,8
serve-fleet:
	$(PY) -m tpu_paxos serve --fleet --lane-counts $(SERVE_LANES) \
	  --values $(or $(VALUES),128) --sweep $(SERVE_RATES) \
	  --drop-rate 500 --dup-rate 1000 --max-delay 2 $(SERVE_FLAGS)

# Quick pass (wired into make check): a small 2-lane fleet at a
# sustained rate with an SLO armed; exits non-zero if any lane fails
# to drain or the confirmed SLO verdict breaches.
serve-fleet-quick:
	$(PY) -m tpu_paxos serve --fleet --lanes 2 --values 48 \
	  --rate-milli 4000 --slo-latency 128 \
	  --drop-rate 500 --dup-rate 1000 --max-delay 2

# Adaptive serving (tpu_paxos/serve/control.py): THE spike A/B
# judgment at the committed BENCH_serve_control.json shape — a 4x
# mid-run load spike on an admission-capped engine (assign_window=8),
# served controller-off then controller-on at the same offered
# trajectory.  Exits non-zero unless controller-on names strictly
# fewer breach windows, sheds only outside gray-region-attributed
# windows, and actually shed something.  Engine seed 3, arrivals
# seed 0 (the decoupled pair the committed record pins).
serve-control:
	$(PY) -m tpu_paxos serve --control-ab --nodes 3 --values 1000 \
	  --rate-milli 2000 --spike-factor 4 --spike-start-frac 0.25 \
	  --spike-len-frac 0.5 --slo-latency 16 --slo-budget-milli 150 \
	  --rounds-per-window 4 --windows-per-dispatch 2 \
	  --window-rounds 32 --instances 2048 --assign-window 8 \
	  --max-rounds 8000 --seed 3 --arrival-seed 0 $(SERVE_FLAGS)

# Quick pass (wired into make check): a small controller-armed run at
# a sustained rate — the controller must stay quiet (no spurious
# degrade), the stream must drain, and the SLO verdict must hold.
serve-control-quick:
	$(PY) -m tpu_paxos serve --nodes 3 --values 60 --rate-milli 2000 \
	  --slo-latency 16 --slo-budget-milli 150 --control \
	  --rounds-per-window 4 --windows-per-dispatch 2 \
	  --window-rounds 32 --max-rounds 4000

# The debug.conf.sample workload end-to-end on the tpu engine.
run:
	$(PY) -m tpu_paxos 4 4 10 --seed=0 --net-drop-rate=500 \
	  --net-dup-rate=1000 --net-min-delay=0 --net-max-delay=2

clean:
	rm -rf build
