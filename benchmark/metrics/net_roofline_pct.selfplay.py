"""net_roofline_pct.selfplay: the network calls' share of their roofline in
the profiled ply, in %: the least time the calls need (``call_least_s`` of
the configuration's architecture, ``benchmark/nets/<arch>.py``; for
``resnet`` ``yardstick.net_call_least_s``: each call's convs at the
configuration's ``peak`` and heads at float32's, or its bytes at the HBM's
bandwidth, whichever is longer) / the union of the device intervals
launched inside the harness's range around the eval function.  Moves
``selfplay_moves_per_s``."""


def read(ctx):
    sl = ctx["slice"]
    busy = sl.busy_ns("net")
    if busy <= 0 or not ctx["net_calls"]:
        return None
    least = sum(ctx["net"].call_least_s(b, ctx["config"])
                for b in ctx["net_calls"])
    return 100.0 * least * 1e9 / busy
