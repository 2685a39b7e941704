"""The traffic generator: deterministic from the seed, its scenes the
program's own synthetic draw, the same work for every seed."""

import numpy as np

from segbench import traffic

SEED = 2 ** 33 + 17  # seeds may exceed 32 bits


def _mix(name="hard256", pool=4, hw=48):
    mix = dict(traffic.load_mix(name), pool=pool)
    mix["scene"] = dict(mix["scene"], height=hw, width=hw)
    mix.pop("canvas", None)
    return mix


def test_batches_are_deterministic_from_the_seed():
    mix = _mix()
    a = traffic.make_batches(mix, SEED, 3, 2)
    b = traffic.make_batches(mix, SEED, 3, 2)
    c = traffic.make_batches(mix, SEED + 1, 3, 2)
    for x, y in zip(a, b):
        assert np.array_equal(x["images"], y["images"])
        assert np.array_equal(x["rows"], y["rows"])
    assert not all(np.array_equal(x["rows"], y["rows"]) for x, y in zip(a, c))


def test_base_scenes_are_the_programs_draw():
    from tpuseg_torch.data.synthetic import make_scene

    mix = _mix()
    pool = traffic.draw_pool(mix)
    rng = np.random.default_rng(mix["pool_seed"])
    counts = rng.permutation(traffic.leaf_counts(mix))
    s = mix["scene"]
    for (rgb, sem, ins, n), k in zip(pool, counts):
        ergb, esem, eins, en = make_scene(rng, s["height"], s["width"],
                                          min_leaves=int(k),
                                          max_leaves=int(k), hard=s["hard"])
        assert np.array_equal(rgb, ergb) and np.array_equal(ins, eins)
        assert n == en


def test_every_seed_gets_the_same_scenes_in_another_order():
    mix = _mix(pool=10)
    assert sorted(traffic.leaf_counts(mix)) == list(range(3, 13))
    a = traffic.draw_rows(mix, 1, 10, 3)
    b = traffic.draw_rows(mix, 2, 10, 3)
    for j in range(3):  # each batch holds every scene once
        assert sorted(a[j][:, 0]) == sorted(b[j][:, 0]) == list(range(10))
    assert not np.array_equal(a, b)


def test_a_batch_smaller_than_the_pool_still_covers_it_evenly():
    mix = _mix(pool=12)
    rows = traffic.draw_rows(mix, SEED, 8, 3)  # 24 rows: every scene twice
    assert sorted(rows[..., 0].ravel()) == sorted(list(range(12)) * 2)
    assert len({tuple(r) for r in rows.reshape(-1, 2)}) == 24


def test_leaf_counts_spread_over_the_range():
    mix = traffic.load_mix("a1hard")
    assert traffic.leaf_counts(mix) == list(range(3, 15))
    assert traffic.leaf_counts(mix, 4) == [3, 7, 10, 14]
    assert traffic.leaf_counts(traffic.load_mix("hard256"), 16) == (
        list(range(3, 13)) + list(range(3, 9)))


def _same_scenes(a, b):
    return all(np.array_equal(p[0], q[0]) for p, q in zip(a, b))


def test_the_seeded_pool_follows_the_seed_and_the_fixed_pool_does_not():
    mix = dict(_mix(pool=2, hw=32), seeded_pool=2, seeded_batches=1)
    batches = traffic.make_batches(mix, SEED, 2, 1)
    assert [b["seeded"].tolist() for b in batches] == [[False] * 2,
                                                        [True] * 2]
    assert _same_scenes(traffic.draw_pool(mix, SEED),
                        traffic.draw_pool(mix, SEED + 1))
    assert _same_scenes(traffic.draw_seeded_pool(mix, SEED),
                        traffic.draw_seeded_pool(mix, SEED))
    assert not _same_scenes(traffic.draw_seeded_pool(mix, SEED),
                            traffic.draw_seeded_pool(mix, SEED + 1))


def test_a_pool_without_its_own_seed_is_drawn_from_the_run_seed():
    mix = _mix(pool=2, hw=32)
    mix.pop("pool_seed")
    a = traffic.draw_pool(mix, SEED)
    assert _same_scenes(a, traffic.draw_pool(mix, SEED))
    assert not _same_scenes(a, traffic.draw_pool(mix, SEED + 1))


def test_first_rows_all_differ_and_transforms_keep_shape():
    mix = _mix(pool=4)
    rows = traffic.draw_rows(mix, SEED, 8, 4).reshape(-1, 2)  # 2 reps a batch
    assert len({tuple(r) for r in rows}) == 32
    a = np.arange(2 * 3 * 1).reshape(2, 3, 1)
    assert all(traffic.transform(a, k).shape == a.shape for k in range(4))
    sq = np.arange(9).reshape(3, 3, 1)
    outs = {traffic.transform(sq, k).tobytes() for k in range(8)}
    assert len(outs) == 8


def test_canvas_pads_at_the_top_left():
    mix = traffic.load_mix("a1hard")
    mix = dict(mix, pool=2, scene=dict(mix["scene"], height=40, width=30),
               canvas=[64, 64])
    b = traffic.make_batches(mix, SEED, 2, 1)[0]["images"]
    assert b.shape == (2, 64, 64, 3)
    assert not b[:, 40:].any() and not b[:, :, 30:].any()


def test_training_rows_carry_their_targets():
    mix = dict(traffic.load_mix("train256"), pool=2)
    mix["scene"] = dict(mix["scene"], height=32, width=32)
    b = traffic.make_batches(mix, SEED, 3, 1, max_n_objects=32)[0]
    assert b["ins_masks"].shape == (3, 32, 32, 32)
    sem = b["sem_onehot"].argmax(-1)
    assert np.array_equal(sem, (b["ins_masks"].sum(-1) > 0))
    assert np.array_equal(b["n_objects"],
                          (b["ins_masks"].sum((1, 2)) > 0).sum(-1))
