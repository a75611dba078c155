"""The benchmark's fixed arithmetic, and the per-layer metric readers on a
synthetic slice."""

import pytest

from benchmark import spec, yardstick
from benchmark.trace import Slice


@pytest.mark.parametrize("cin,flops", [(3, 798_222_600), (5, 799_259_400)])
def test_flops_of_the_6x128_net(cin, flops):
    assert yardstick.net_flops_per_eval(15, 6, 128, cin) == flops


@pytest.mark.parametrize("config", [c["name"] for c in
                                    spec.benchmark()["configs"]])
@pytest.mark.parametrize("batch", [1, 8, 128, 1024])
def test_resnet_counts_are_the_yardsticks(config, batch):
    """``nets/resnet.py`` gives the readers ``yardstick``'s numbers, bit for
    bit."""
    c = spec.config(config)
    net = spec.net("resnet")
    assert net.flops_per_eval(c) == yardstick.net_flops_per_eval(
        c["board_size"], c["n_res_blocks"], c["channels"], c["in_channels"])
    assert net.call_least_s(batch, c) == yardstick.net_call_least_s(
        batch, c["board_size"], c["n_res_blocks"], c["channels"],
        c["in_channels"], c["peak"], c["value_hidden"])


def test_busy_is_the_union():
    spans = [(0, 10), (5, 12), (20, 30), (21, 22), (40, 41)]
    assert yardstick.busy_ns(spans) == 12 + 10 + 1
    assert yardstick.busy_ns([]) == 0


def test_gaps_cover_the_rest():
    spans = [(5, 12), (0, 10), (20, 30)]
    assert yardstick.gaps(spans, -3, 35) == [(-3, 0), (12, 20), (30, 35)]
    assert yardstick.gaps([], 0, 4) == [(0, 4)]


def test_net_call_is_compute_bound_at_batch():
    # 128 boards: 128 * 797.8 MOP at 1978.9 TOP/s ~ 51.6 us, far above the
    # bytes' ~1 us at 3.35 TB/s
    t = yardstick.net_call_least_s(128, 15, 6, 128, 3, "int8")
    ops = 128 * yardstick.conv_flops(15, 6, 128, 3) / 1978.9e12
    assert ops < t < ops * 1.02
    one = yardstick.net_call_least_s(1, 15, 6, 128, 3, "int8")
    assert one == yardstick.net_call_bytes(1, 15, 6, 128, 3) / 3.35e12


def _slice():
    # host: net [0, 100], tree [150, 200], game [210, 260]; the launches
    # of ops 1-5 at those times, op 6 launched from the glue, op 7 unknown
    ranges = [("tree", 150, 200), ("net", 0, 100), ("game", 210, 260)]
    launches = {1: 10, 2: 20, 3: 160, 4: 220, 5: 230, 6: 120}
    device = [("conv_kernel", 30, 80, 1), ("conv_kernel", 70, 90, 2),
              ("select_walk_kernel", 170, 175, 3),
              ("elementwise", 240, 244, 4), ("gather", 250, 252, 5),
              ("memcpy", 130, 131, 6), ("mystery", 300, 302, 7)]
    return Slice(0, 400, ranges, launches, device)


def test_attribution_by_launch_time():
    sl = _slice()
    assert sl.layer_of() == ["net", "net", "tree", "game", "game", "glue",
                             "glue"]
    assert sl.unmatched() == 1
    assert sl.busy_ns("net") == 60
    assert sl.busy_ns("tree") == 5
    assert sl.busy_ns("game") == 6
    assert sl.busy_ns() == 60 + 5 + 6 + 1 + 2
    assert (sl.count(), sl.count("net"), sl.count("glue")) == (7, 2, 2)


def test_breakdown():
    sl = _slice()
    bd = sl.breakdown()
    assert bd["device_ops"][0] == ["conv_kernel", 70 / 1e9]
    idle = dict(bd["idle_gaps"])
    # gaps: [0, 30] net, [90, 130] glue (mid 110), [131, 170] tree (mid
    # 150.5), [175, 240] game (mid 207.5 is glue), [244, 250] game,
    # [252, 300] glue, [302, 400] glue
    assert idle["host in net"] == pytest.approx(30 / 1e9)
    assert idle["host in tree"] == pytest.approx(39 / 1e9)
    assert idle["host in game"] == pytest.approx(6 / 1e9)
    assert sum(idle.values()) == pytest.approx((400 - sl.busy_ns()) / 1e9)


def _ctx(sl):
    cfg = spec.config("gomoku15-6x128-int8t")
    return {"slice": sl, "sims": 4, "net_calls": [128, 128],
            "calls": [{"moves": 10, "seconds": 9.0, "profiled": True},
                      {"moves": 6000, "seconds": 8.0, "profiled": False},
                      {"moves": 6144, "seconds": 8.5, "profiled": False}],
            "config": cfg, "net": spec.net("resnet"),
            "traffic": spec.traffic("gumbel64-reuse48-b128")}


def test_metric_readers_on_a_synthetic_slice():
    sl = _slice()
    ctx = _ctx(sl)

    def read(name):
        return spec.metric_reader(name)(ctx)

    assert read("device_idle_pct.selfplay") == pytest.approx(
        100 * (1 - 74 / 400))
    assert read("device_ops_per_sim.selfplay") == 7 / 4
    assert read("tree_device_us_per_sim.selfplay") == pytest.approx(
        5 / 1e3 / 4)
    assert read("game_device_us_per_sim.selfplay") == pytest.approx(
        6 / 1e3 / 4)
    least = 2 * yardstick.net_call_least_s(128, 15, 6, 128, 3, "int8")
    assert read("net_roofline_pct.selfplay") == pytest.approx(
        100 * least * 1e9 / 60)
    flops = yardstick.net_flops_per_eval(15, 6, 128, 3)
    assert read("step_mfu_pct.selfplay") == pytest.approx(
        100 * 12144 * 64 * flops / 16.5 / 1978.9e12)


def test_readers_return_nothing_without_a_reading():
    empty = Slice(0, 100, [], {}, [])
    ctx = dict(_ctx(empty), sims=0, net_calls=[],
               calls=[{"moves": 5, "seconds": 1.0, "profiled": True}])
    for m in spec.benchmark()["per_layer"]:
        assert spec.metric_reader(m["name"])(ctx) is None, m["name"]
