"""``result_ms.sim`` (result): host ms in ``core/sim.to_result`` (the
final state to host numpy) a run."""

SPANS = {"result": ["tpu_paxos_torch.core.sim:to_result"]}


def read(r):
    calls = r.block_calls.get("result", 0)
    return r.blocks_ms["result"] / calls if calls else None
