"""gpool_roofline_pct.selfplay: the network's global poolings' share of their
roofline in the profiled ply, in %: the least time of the calls' poolings
(``gpool_least_s`` of the configuration's architecture,
``benchmark/nets/<arch>.py``: their bytes at the HBM's bandwidth) / the
union of the device intervals of the operations launched inside the
harness's range around the eval function whose names hold ``kata_gpool``
(the program's pooling kernel).  None where the architecture has no
poolings or the slice holds no such operation.  Moves
``selfplay_moves_per_s``."""

from benchmark.yardstick import busy_ns

KERNEL = "kata_gpool"


def read(ctx):
    least_s = getattr(ctx["net"], "gpool_least_s", None)
    if least_s is None or not ctx["net_calls"]:
        return None
    sl = ctx["slice"]
    spans = [(s, e) for (name, s, e, _), layer in zip(sl.device,
                                                       sl.layer_of())
             if layer == "net" and KERNEL in name]
    busy = busy_ns(spans)
    if busy <= 0:
        return None
    least = sum(least_s(b, ctx["config"]) for b in ctx["net_calls"])
    return 100.0 * least * 1e9 / busy
