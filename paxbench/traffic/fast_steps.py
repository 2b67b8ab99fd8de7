"""Traffic kind ``fast_steps``: fast-path steps back to back, a closed loop
in which each step's client waits for its counts on the host.

The configuration gives ``n_nodes`` and ``n_instances`` (the ``[A, I]``
int32 state); the mix gives ``quorum`` and the step:

- ``"windows"``: ``core/fastwin.steady_state_windows_fused(state, None,
  reps, quorum, iota_vids=True)``: one prepare by proposer 0, then
  ``reps`` accept+learn windows of I fresh instances with sequential
  vids.  From the seed: each acceptor's prior ballot (``promised`` =
  ``max_seen``, below ``prior_ballot_max``).
- ``"takeover"``: ``core/fast.choose_all(state, vids, proposer,
  quorum)``: the next proposer of the cycle takes over the whole log
  (phase 1 with adoption over every instance, accept, learn).  From the
  seed: the first proposer of the cycle; the new leaders' own vids
  (``offset + i``); a prior log in which each acceptor holds a
  pre-accepted value at an instance with probability
  ``preaccept_per_mille`` / 1000, at a ballot of a count below
  ``prior_count_max`` and a node below ``n_nodes`` (one ballot, one
  value at an instance).

Every seed gives the same sizes and the same work.  Inputs are made on
the device by one ``torch.Generator`` in a few large calls; the reference
makes them again from the seed after the window.  The warm-up step is the
run's first step (the reference follows it too).

Every window of a ``"windows"`` step overwrites the same arrays, so the
final state shows only the last window of the last step.  Once the
window has closed, the check makes one more step on the same state
through the same call with a probe on each window's end
(:data:`WINDOW_PROBES`), which copies a seeded sample of instance
columns as that window leaves them; the reference compares each window
with its own vids.
"""

from __future__ import annotations

import torch

from paxbench import yardstick
from paxbench.reference import fast_reference as ref

_I32 = torch.int32
NONE = yardstick.NONE

SPANS = {
    "fast step": ["tpu_paxos_torch.core.fast:choose_all",
                  "tpu_paxos_torch.core.fastwin:steady_state_windows_fused"],
    "phase 1": ["tpu_paxos_torch.core.fast:phase1_prepare",
                "tpu_paxos_torch.core.fastwin:window_scalars"],
    "window launches": ["tpu_paxos_torch.core.fastwin:steady_state_windows_cuda"],
}

#: Instance columns the takeover reference replays every step on (a
#: sample drawn from the seed; the first and last instance always in it).
TAKEOVER_SAMPLE = 1 << 20

#: Instance columns the probed step's windows are read on (drawn from the
#: seed; the first and last instance always in it).
WINDOW_SAMPLE = 1 << 18

#: Where a window ends: each window launch is checked on a card; the
#: plain path (a CPU) ends each window with its learn.
WINDOW_PROBES = ("tpu_paxos_torch.utils.kbuild:check_launch",
                 "tpu_paxos_torch.core.fast:phase3_learn")


def _gen(ctx, tag: str) -> torch.Generator:
    g = torch.Generator(device=ctx.device)
    g.manual_seed(ctx.derive(tag))
    return g


def sample_columns(ctx, i: int, n: int, tag: str) -> torch.Tensor:
    """``n`` instance columns of ``[0, i)`` drawn from the seed, with the
    first and last instance, sorted (int64)."""
    cols = torch.randperm(i, generator=_gen(ctx, tag), device=ctx.device)[:n]
    return torch.cat([cols, torch.tensor([0, i - 1], device=ctx.device)]).unique()


def prior_ballots(ctx, a: int) -> torch.Tensor:
    """Steady: each acceptor's prior ballot ``[A]``."""
    g = _gen(ctx, "prior")
    return torch.randint(0, ctx.mix["prior_ballot_max"], (a,), generator=g,
                         device=ctx.device, dtype=torch.int64).to(_I32)


def prior_log(ctx, a: int, i: int):
    """Takeover: ``(acc_ballot, acc_vid, vids, first proposer)``; the
    acceptors' scalars are the row maxima of ``acc_ballot``."""
    m, dev = ctx.mix, ctx.device
    g = _gen(ctx, "log")
    held = torch.randint(0, 1000, (a, i), generator=g, device=dev, dtype=torch.int16)
    held = held < m["preaccept_per_mille"]
    count = torch.randint(1, m["prior_count_max"], (a, i), generator=g, device=dev,
                          dtype=_I32)
    node = torch.randint(0, a, (a, i), generator=g, device=dev, dtype=_I32)
    ballot = (count << yardstick.NODE_BITS) | node
    # one ballot, one value at an instance: the value is a function of both
    lane = (count * a + node) % 8
    vid = lane * i + torch.arange(i, dtype=_I32, device=dev)[None, :]
    acc_ballot = torch.where(held, ballot, NONE)
    acc_vid = torch.where(held, vid, NONE)
    del held, count, node, ballot, lane, vid
    head = torch.randint(0, 1 << 29, (2,), generator=g, device=dev, dtype=torch.int64)
    offset = (1 << 30) + int(head[0])
    vids = torch.arange(offset, offset + i, dtype=torch.int64, device=dev).to(_I32)
    return acc_ballot, acc_vid, vids, int(head[1]) % a


class Driver:
    def __init__(self, ctx):
        from tpu_paxos_torch.core import fast, fastwin

        self.ctx = ctx
        self._fast, self._fastwin = fast, fastwin
        self.a, self.i = ctx.config["n_nodes"], ctx.config["n_instances"]
        self.quorum = ctx.mix["quorum"]
        self.kind = ctx.mix["step"]
        self.counts = []  # each step's counts, host ints
        self.state = fast.init_state(self.i, self.a, device=ctx.device)
        if self.kind == "windows":
            self.reps = ctx.mix["reps"]
            prior = prior_ballots(ctx, self.a)
            self.state.promised.copy_(prior)
            self.state.max_seen.copy_(prior)
        elif self.kind == "takeover":
            acc_ballot, acc_vid, self.vids, self.first = prior_log(ctx, self.a, self.i)
            scal = acc_ballot.amax(dim=1)
            self.state = self.state._replace(acc_ballot=acc_ballot, acc_vid=acc_vid,
                                             promised=scal.clone(), max_seen=scal)
        else:
            raise ValueError(f"unknown fast step {self.kind!r}")

    def warm(self) -> None:
        self._step()

    def _step(self) -> None:
        if self.kind == "windows":
            self.state, counts = self._fastwin.steady_state_windows_fused(
                self.state, None, reps=self.reps, quorum=self.quorum, iota_vids=True)
            got = counts.tolist()  # the client's wait: counts on the host
        else:
            node = (self.first + len(self.counts)) % self.a
            self.state, n = self._fast.choose_all(self.state, self.vids, node, self.quorum)
            got = [int(n.item())]
        self.counts.append(got)

    def step(self, k: int) -> dict:
        self._step()
        return {}

    def values(self, k: int) -> int:
        return sum(self.counts[k + 1])  # counts[0] is the warm-up step

    def release(self) -> None:
        if self.ctx.device != "cpu":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------- reference

    def check(self):
        """``(numbers, failed, attempted)``: each number with its limit,
        the steps whose counts were wrong (and one for a wrong final
        state or window), and the steps compared (the warm-up's and the
        probed step's too)."""
        if self.kind == "windows":
            return self._check_windows()
        return self._check_takeover()

    def _probed_step(self, cols: torch.Tensor) -> list:
        """One more step, each window's sampled columns copied as the
        window ends: ``[(acc_ballot, acc_vid, learned), ...]`` in window
        order.  A step that raises leaves the windows it did not reach
        unread."""
        from paxbench.spans import resolve

        seen, saved = [], []

        def read(st) -> None:
            seen.append(tuple(x.index_select(1, cols)
                              for x in (st.acc_ballot, st.acc_vid, st.learned)))

        def on_launch(fn):
            def wrapped(lib, name, *a, **kw):
                out = fn(lib, name, *a, **kw)
                if name == "fastwin":
                    read(self.state)
                return out
            return wrapped

        def on_learn(fn):
            def wrapped(*a, **kw):
                out = fn(*a, **kw)
                read(out)
                return out
            return wrapped

        for target, make in zip(WINDOW_PROBES, (on_launch, on_learn)):
            try:
                owner, attr, fn = resolve(target)
            except (ImportError, AttributeError):  # a probe gone: its windows unread
                continue
            saved.append((owner, attr, fn))
            setattr(owner, attr, make(fn))
        try:
            self._step()
        except Exception:  # noqa: BLE001 - its windows count as unread
            pass
        finally:
            for owner, attr, fn in reversed(saved):
                setattr(owner, attr, fn)
        return seen

    def _check_windows(self):
        cols = sample_columns(self.ctx, self.i, WINDOW_SAMPLE, "windows")
        n_before = len(self.counts)
        seen = self._probed_step(cols)
        st, dev = self.state, self.ctx.device
        prior = prior_ballots(self.ctx, self.a).tolist()
        n_steps = n_before + 1
        sc, verdicts = ref.steady_expected(prior, n_steps, self.reps, self.quorum)
        want = ref.steady_counts(verdicts, self.i)
        got = [c for step in self.counts for c in step]
        bad_counts = sum(x != y for x, y in zip(got, want)) + abs(len(got) - len(want))
        bad_steps = sum(
            step != want[k * self.reps:(k + 1) * self.reps] for k, step in enumerate(self.counts))
        bad_steps += len(self.counts) < n_steps
        # the probed step's windows: a window unread counts every cell
        win_cells = 3 * self.a * len(cols) * abs(len(seen) - self.reps)
        for k, have in enumerate(seen[:self.reps]):
            exp = ref.steady_window(verdicts[-1], k, self.i, cols)
            win_cells += sum(int((h != w).sum()) for h, w in zip(have, exp))
        del seen
        cells = 0
        block = 1 << 24
        for lo in range(0, self.i, block):
            span = torch.arange(lo, min(self.i, lo + block), dtype=torch.int64, device=dev)
            exp = ref.steady_window(verdicts[-1], self.reps - 1, self.i, span)
            for have, w in zip((st.acc_ballot, st.acc_vid, st.learned), exp):
                cells += int((have[:, lo:lo + len(span)] != w).sum())
        scalars = sum(int(x) != y for x, y in zip(st.promised.tolist(), sc.promised))
        scalars += sum(int(x) != y for x, y in zip(st.max_seen.tolist(), sc.max_seen))
        return ([("count_mismatch", bad_counts, 0), ("cell_mismatch", cells, 0),
                 ("window_mismatch", win_cells, 0), ("acceptor_mismatch", scalars, 0)],
                bad_steps + (cells > 0 or scalars > 0 or win_cells > 0), n_steps)

    def _check_takeover(self):
        st = self.state
        acc_ballot, acc_vid, vids, first = prior_log(self.ctx, self.a, self.i)
        scal = acc_ballot.amax(dim=1).tolist()
        cols = sample_columns(self.ctx, self.i, TAKEOVER_SAMPLE, "sample")
        b, v = acc_ballot[:, cols], acc_vid[:, cols]
        del acc_ballot, acc_vid
        lrn = torch.full_like(b, NONE)
        own = vids[cols]
        sc = ref.Scalars(scal, scal, self.quorum)
        want = []
        for k in range(len(self.counts)):
            b, v, lrn, decided = ref.takeover_step(sc, (first + k) % self.a, b, v, lrn, own)
            # the learners never forget, and a prepared leader's batch is
            # never NONE (own vids never are): once a step decides, every
            # instance is learned
            want.append(self.i if decided or (want and want[-1] == self.i) else 0)
        got = [step[0] for step in self.counts]
        bad_counts = sum(x != y for x, y in zip(got, want))
        cells = sum(int((have[:, cols] != w).sum())
                    for have, w in zip((st.acc_ballot, st.acc_vid, st.learned), (b, v, lrn)))
        scalars = sum(int(x) != y for x, y in zip(st.promised.tolist(), sc.promised))
        scalars += sum(int(x) != y for x, y in zip(st.max_seen.tolist(), sc.max_seen))
        return ([("count_mismatch", bad_counts, 0), ("sampled_cell_mismatch", cells, 0),
                 ("acceptor_mismatch", scalars, 0)],
                bad_counts + (cells > 0 or scalars > 0), len(self.counts))


def build(ctx) -> Driver:
    return Driver(ctx)
