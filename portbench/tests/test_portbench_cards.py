"""A cell over several cards: the profile's busy time is each card's own,
its idle gaps those of every card at once, and K3's roofline counts the
grids of the scans stepped, whatever the launches that walked them. On one card all read as they did
before there was a card axis (the loops below are the code they replaced,
kept as the oracle)."""

import types

import pytest
import torch

from portbench import readers, roofline, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _event(start, end, name, device_type=CUDA, device_index=0, annotation=False):
    return types.SimpleNamespace(time_range=types.SimpleNamespace(start=start, end=end),
                                 name=name, device_type=device_type, device_index=device_index,
                                 is_user_annotation=annotation)


def _profile(acts, w0=10.0, w1=110.0):
    """A stub profile: the window's marks, one host span, and ``acts``
    (start, end, name, device index) as device activities."""
    events = [_event(w0, w0, trace.OPEN, CPU, annotation=True),
              _event(w1, w1, trace.CLOSE, CPU, annotation=True),
              _event(w0, w1, "fleet.step", CPU, annotation=True)]
    events += [_event(s, e, name, device_index=d) for s, e, name, d in acts]
    return types.SimpleNamespace(events=lambda: events)


def _old_union(prof):
    """The busy time and idle gaps the profile's summary gave before it
    kept each activity's card: one timeline for every activity."""
    events = prof.events()
    acts = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.device_type == CUDA and not e.is_user_annotation), key=lambda a: a[0])
    marks = {e.name: e.time_range.start for e in events if e.name in (trace.OPEN, trace.CLOSE)}
    w0, w1 = marks[trace.OPEN], marks[trace.CLOSE]
    inside = [a for a in acts if a[1] > w0 and a[0] < w1]
    busy, gaps, cur_s, cur_e = 0.0, [], None, None
    for s, e, _ in inside:
        s, e = max(s, w0), min(e, w1)
        if cur_e is None:
            if s > w0:
                gaps.append((w0, s))
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        if cur_e < w1:
            gaps.append((cur_e, w1))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    return busy, [(e - s) / 1e6 for s, e in gaps[:10]]


ONE_CARD = [(5.0, 12.5, "spiral_kernel", 0), (12.0, 30.1, "raster_reduce_kernel", 0),
            (31.7, 31.9, "Memcpy DtoD", 0), (40.3, 77.7, "spiral_kernel", 0),
            (50.0, 60.0, "move_kernel", 0), (108.0, 115.0, "spiral_kernel", 0)]
# card 1 busy where card 0 idles and where it works: 30-45 and 80-90
TWO_CARDS = ONE_CARD + [(30.0, 45.0, "spiral_kernel", 1), (80.0, 90.0, "move_kernel", 1)]


@pytest.mark.parametrize("acts", [ONE_CARD, TWO_CARDS])
def test_summary_union_is_the_old_code(acts):
    prof = _profile(acts)
    got = trace.summarize(prof, ["spiral_kernel"])
    busy, gaps = _old_union(prof)
    assert [g for _, g in got["idle_gaps"]] == gaps
    assert got["activities"] == len(acts)
    if acts is ONE_CARD:
        assert got["card_busy_us"] == {0: busy}


def test_summary_gives_each_card_its_own_busy_time():
    one = trace.summarize(_profile(ONE_CARD), ["spiral_kernel"])
    two = trace.summarize(_profile(TWO_CARDS), ["spiral_kernel"])
    assert list(one["card_busy_us"]) == [0]
    # card 0's own union (10-30.1, 31.7-31.9, 40.3-77.7, 108-110) is what it was alone
    assert two["card_busy_us"][0] == one["card_busy_us"][0]
    assert two["card_busy_us"][0] == pytest.approx(20.1 + 0.2 + 37.4 + 2.0)
    assert two["card_busy_us"][1] == 25.0
    # the union is no card's busy time: card 1 fills card 0's gaps up to 77.7
    busy, _ = _old_union(_profile(TWO_CARDS))
    assert busy == pytest.approx((77.7 - 10.0) + (90.0 - 80.0) + (110.0 - 108.0))
    assert max(two["card_busy_us"].values()) < busy


def _cx(profile, unit_scans, cards):
    devices = [torch.device("cuda", k) for k in range(cards)]
    return types.SimpleNamespace(profile=profile, devices=devices,
                                 loop=types.SimpleNamespace(unit_scans=unit_scans),
                                 cfg=types.SimpleNamespace(cell_count=364),
                                 window=types.SimpleNamespace(scans=unit_scans * 1000,
                                                              elapsed=4.0))


def _stub(launches, us, scans, card_busy_us=None):
    return {"scans": scans, "activities": 3 * launches, "units": list(range(scans)),
            "by_name": {"void spiral_kernel<2>(float*)": [us, launches]},
            "card_busy_us": card_busy_us or {0: 0.0}}


def test_k3_roofline_counts_a_cards_block_a_launch():
    # one card: 10 ticks of 64 vehicles, one launch a tick walking 64 grids
    one = _cx(_stub(10, 6400.0, 640), 64, 1)
    # two cards of equal blocks: 10 ticks of 128 vehicles, two launches a tick
    two = _cx(_stub(20, 12800.0, 1280), 128, 2)
    share = readers.k3_roofline(one)
    assert readers.k3_roofline(two) == share
    # on one card, the count before there was a card axis
    old = 100.0 * roofline.bound_s(roofline.k3_bytes(364) * 64 * 10) / (6400.0 / 1e6)
    assert share == old


def test_k3_roofline_counts_the_scans_not_the_launches():
    # 10 ticks of 64 vehicles stepped vehicle by vehicle: 640 launches of one
    # grid each, in the time of the batched tick's 10 launches of 64 grids
    batched = _cx(_stub(10, 6400.0, 640), 64, 1)
    per_vehicle = _cx(_stub(640, 6400.0, 640), 64, 1)
    assert readers.k3_roofline(per_vehicle) == readers.k3_roofline(batched)
    # the same grids in twice the time read half the share
    slower = _cx(_stub(640, 12800.0, 640), 64, 1)
    assert readers.k3_roofline(slower) == pytest.approx(readers.k3_roofline(batched) / 2)


@pytest.mark.parametrize("cards", [1, 2])
def test_busy_and_idle_share_are_each_cards_the_mean_over_the_cards(cards):
    card_busy_us = {0: 300.0, 1: 500.0} if cards == 2 else {0: 300.0}
    cx = _cx(_stub(20, 12800.0, 1280, card_busy_us), 128, cards)
    block = 1280 / cards  # a card's block's scans in the profile
    rate = 128 * 1000 / cards / 4.0  # a block's scans a second in the window
    busy = [b / block / 1000 for b in card_busy_us.values()]  # each card's ms a scan
    assert readers.device_busy_ms(cx) == pytest.approx(sum(busy) / cards)
    want = sum(100 * (1 - b / 1000 * rate) for b in busy) / cards
    assert readers.device_idle_share(cx) == pytest.approx(want)
    if cards == 1:
        # the code before there was a card axis, on the union of one card
        busy_us = card_busy_us[0]
        assert readers.device_busy_ms(cx) == busy_us / 1000.0 / 1280
        assert readers.device_idle_share(cx) == 100.0 * (
            1.0 - busy_us / 1e6 / 1280 * cx.window.scans / cx.window.elapsed)
