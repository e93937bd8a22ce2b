"""The traffic generator: a seed gives the same requests every time,
another seed other requests, and every seed the same amount of work."""
from __future__ import annotations

import json

import numpy as np
import pytest

from portbench import bench, traffic

MIX = {"loop": "open", "arrivals": "poisson", "rate_rps": 800.0,
       "size_mix": [[1, 3.0], [4, 1.0]], "pool_images": 1024}
SEEDS = (7, 2 ** 31 + 5, 2 ** 33 + 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_open_plan_repeats_for_a_seed(seed):
    assert (traffic.open_plan(MIX, seed, 3.0, 1024)
            == traffic.open_plan(MIX, seed, 3.0, 1024))


def test_open_plan_differs_between_seeds_in_order_not_work():
    plans = [traffic.open_plan(MIX, s, 3.0, 1024) for s in SEEDS]
    assert plans[0] != plans[1] != plans[2]
    for p in plans:
        due = np.array([t for t, _, _ in p])
        assert len(p) == round(MIX["rate_rps"] * 3.0)
        assert np.all(np.diff(due) > 0) and due[-1] == pytest.approx(3.0)
        assert sorted(np.diff(due, prepend=0.0)) == pytest.approx(
            sorted(np.diff([t for t, _, _ in plans[0]], prepend=0.0)))
        sizes = [r for _, _, r in p]
        assert sizes.count(1) == 1800 and sizes.count(4) == 600
        assert all(0 <= o <= 1024 - r for _, o, r in p)


def test_open_plan_gaps_are_exponential():
    p = traffic.open_plan({**MIX, "size_mix": [[1, 1]]}, 3, 20.0, 1024)
    gaps = np.diff([t for t, _, _ in p], prepend=0.0)
    assert gaps.mean() == pytest.approx(1 / 800.0, rel=1e-3)
    assert np.median(gaps) == pytest.approx(np.log(2) / 800.0, rel=0.01)


def test_closed_loop_offsets_repeat_for_a_seed_and_differ_across():
    mix = {"loop": "closed", "clients": 4, "request_images": 256}

    def offsets(seed):
        g = traffic.ClosedLoop(mix, seed, 1024)
        return [g.next_offset() for _ in range(50)]

    assert offsets(11) == offsets(11)
    assert offsets(11) != offsets(12)
    assert 0 <= min(offsets(11)) and max(offsets(11)) <= 1024 - 256


def test_mix_files_load_and_name_their_loop():
    for f in (bench.ROOT / "portbench" / "traffic").glob("*.json"):
        mix = traffic.load(f)
        assert mix["pool_images"] >= 1
        assert json.loads(f.read_text())["why"]


def test_unknown_loop_is_refused(tmp_path):
    f = tmp_path / "bad.json"
    f.write_text(json.dumps({"loop": "sideways"}))
    with pytest.raises(ValueError):
        traffic.load(f)
