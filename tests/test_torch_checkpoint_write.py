"""The port's checkpoint writer and merge-style load against the JAX
package, at the small-width training configuration of
``test_torch_train.py`` (32x32, n_filters 8, max_n_objects 4), on the CPU.

* ``write_msgpack(to_flax(model))`` is byte for byte what
  ``flax.serialization.to_bytes`` writes for that tree; flax's
  ``msgpack_restore`` and the JAX CLIs' ``load_variables`` read it back
  leaf for leaf (keys, shapes, dtypes, values bitwise).
* On a checkpoint that lacks one subtree and holds one leaf at another
  width, the port's ``load_model`` takes exactly the leaves the JAX
  CLIs' ``adapt_cfg_to_checkpoint`` + ``load_variables`` take, keeps the
  rest at its own init and prints the same warnings, where the strict load
  it used to do raises.  The port's own train-state files load the same
  way.

No JAX compile: ``load_variables`` (the init, the file's tree and
``_merge_restore``) gets, in place of its init, a tree of the init's
shapes drawn from a seeded numpy stream (``test_torch_predict._draw``),
the init the merge keeps where the file has no leaf.
"""

import contextlib
import io

import flax.serialization
import jax
import numpy as np
import pytest
import torch
from test_torch_predict import _draw
from test_torch_train import tiny

import tpuseg.cli.common as jax_common
from tpuseg.cli.common import adapt_cfg_to_checkpoint as jax_adapt
from tpuseg.cli.common import build_model, load_variables
from tpuseg.configs import cvppp_config as jax_cvppp_config
from tpuseg_torch.cli.common import init_model, load_model
from tpuseg_torch.configs import cvppp_config
from tpuseg_torch.models import ReSeg
from tpuseg_torch.runtime.checkpoint import save_checkpoint
from tpuseg_torch.runtime.state import create_train_state
from tpuseg_torch.utils.checkpoint_io import (
    flatten, merge_restore, nest, read_msgpack, to_msgpack_bytes,
    write_msgpack,
)
from tpuseg_torch.weights import load_flax, to_flax

torch.set_num_threads(2)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield "/" + "/".join(path), np.asarray(tree)


def _same_tree(got, want, ordered=True):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    if ordered:
        assert list(got) == list(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


@pytest.fixture(scope="module")
def jax_init():
    jcfg = tiny(jax_cvppp_config())
    shapes = jax.eval_shape(
        lambda: jax_common.init_variables(jcfg, build_model(jcfg), 0))
    return _draw(shapes, seed=11)


@pytest.fixture
def one_init(jax_init, monkeypatch):
    """``load_variables`` with the module's drawn init in place of the JAX
    init (seed 0)."""
    def init_variables(cfg, model, seed=0):
        assert cfg == tiny(jax_cvppp_config()) and seed == 0
        return jax_init

    monkeypatch.setattr(jax_common, "init_variables", init_variables)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    model = init_model(tiny(cvppp_config()), seed=5)
    tree = to_flax(model)
    path = str(tmp_path_factory.mktemp("ckpt") / "port.msgpack")
    write_msgpack(path, tree)
    return model, tree, path


def test_written_checkpoint_is_flax_bytes_and_loads_in_jax(written, one_init):
    _, tree, path = written
    with open(path, "rb") as f:
        data = f.read()
    assert data == flax.serialization.to_bytes(tree)
    _same_tree(flax.serialization.msgpack_restore(data), tree)
    _same_tree(read_msgpack(path), tree)
    jcfg = tiny(jax_cvppp_config())
    with contextlib.redirect_stdout(io.StringIO()) as out:
        got = load_variables(jcfg, build_model(jcfg), path)
    assert "[load]" not in out.getvalue()  # every leaf taken
    # the JAX init's key order (params first); the same leaves
    _same_tree(jax.tree_util.tree_map(np.asarray, dict(got)), tree,
               ordered=False)


def test_numpy_scalars_and_odd_sizes_are_written_as_flax_does():
    tree = {"b": {"kernel": np.arange(300, dtype=np.float32).reshape(3, 100),
                  "n": np.int32(-7), "s": np.float32(2.5),
                  "e": np.zeros((0, 2), np.float32)},
            "a": {f"k{i}": np.ones((i,), np.uint8) for i in range(18)},
            "z": np.array(0.25, np.float64)}
    data = to_msgpack_bytes(tree)
    assert data == flax.serialization.to_bytes(tree)
    back = read_msgpack(data)
    assert back["b"]["n"] == np.int32(-7) and isinstance(back["b"]["n"],
                                                         np.int32)
    _same_tree(back, flax.serialization.msgpack_restore(data))


def _doctored(tree):
    """The checkpoint of the merge tests: no ``channel_attend`` subtree and
    the semantic output kernel at another width."""
    params = {k: v for k, v in tree["params"].items()
              if k != "channel_attend"}
    params["sem_seg_output"] = dict(params["sem_seg_output"])
    params["sem_seg_output"]["kernel"] = np.ones((1, 1, 8, 3), np.float32)
    return {**tree, "params": params}


def test_load_model_merges_as_the_jax_clis_do(written, one_init, tmp_path):
    model, tree, _ = written
    stored = _doctored(tree)
    path = str(tmp_path / "partial.msgpack")
    write_msgpack(path, stored)

    with contextlib.redirect_stdout(io.StringIO()) as jout:
        jcfg = jax_adapt(tiny(jax_cvppp_config()), path)
        jvars = load_variables(jcfg, build_model(jcfg), path)
    with contextlib.redirect_stdout(io.StringIO()) as tout:
        tcfg, port = load_model(tiny(cvppp_config()), path)
    assert tcfg == tiny(cvppp_config()) and jcfg == tiny(jax_cvppp_config())
    warnings = lambda s: sorted(  # noqa: E731
        line for line in s.getvalue().splitlines() if "[load]" in line)
    assert warnings(tout) == warnings(jout)
    assert any("missing in ckpt: /params/channel_attend" in w
               for w in warnings(tout))
    assert any("shape mismatch at /params/sem_seg_output/kernel" in w
               for w in warnings(tout))

    # the same leaves taken from the file; the others at each side's init
    want_stored = dict(_leaves(stored))
    jl = dict(_leaves(jax.tree_util.tree_map(np.asarray, dict(jvars))))
    tl = dict(_leaves(to_flax(port)))
    init = dict(_leaves(to_flax(init_model(tcfg, seed=0))))
    assert sorted(jl) == sorted(tl)
    n_taken = 0
    for k in jl:
        j_taken = k in want_stored and jl[k].shape == want_stored[k].shape \
            and np.array_equal(jl[k], want_stored[k])
        t_taken = k in want_stored and tl[k].shape == want_stored[k].shape \
            and np.array_equal(tl[k], want_stored[k])
        assert j_taken == t_taken, k
        if t_taken:
            n_taken += 1
        else:
            np.testing.assert_array_equal(tl[k], init[k], err_msg=k)
    assert n_taken == len(tl) - sum(1 for k in tl if "channel_attend" in k) - 1

    # the strict load the port did before raises on this file
    with pytest.raises(RuntimeError):
        load_flax(ReSeg(tcfg), read_msgpack(path))


def test_merge_restore_is_the_jax_merge_on_a_small_tree(capsys):
    from tpuseg.cli.common import _merge_restore

    init = {"a": {"w": np.zeros((2, 3), np.float32),
                  "b": np.ones(3, np.float32)},
            "c": np.zeros(4, np.float32), "d": {"x": np.ones(1, np.float32)}}
    stored = {"a": {"w": np.ones((2, 3), np.float64), "b": np.ones(4)},
              "c": np.arange(4), "e": np.ones(2)}
    got = merge_restore(init, stored)
    port_out = capsys.readouterr().out
    want = _merge_restore(init, stored)
    jax_out = capsys.readouterr().out
    assert port_out == jax_out
    for (kg, g), (kw, w) in zip(_leaves(got), _leaves(want)):
        assert kg == kw and g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))


def test_port_train_state_files_load_merge_style(tmp_path):
    cfg = tiny(cvppp_config())
    state = create_train_state(cfg, init_model(cfg, seed=2), device="cpu")
    path = str(tmp_path / "model_0")
    save_checkpoint(path, state)
    payload = torch.load(path, weights_only=True)
    sd = payload["model"]
    dropped = [k for k in sd if k.startswith("channel_attend.")]
    for k in dropped:
        del sd[k]
    sd["sem_seg_output.weight"] = torch.ones(3, 8, 1, 1)
    torch.save(payload, path)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        _, model = load_model(cfg, path)
    lines = out.getvalue()
    assert "missing in ckpt: /channel_attend" in lines
    assert "shape mismatch at /sem_seg_output/weight" in lines
    init = init_model(cfg, seed=0).state_dict()
    for k, v in model.state_dict().items():
        want = init[k] if k in dropped or k == "sem_seg_output.weight" \
            else sd[k]
        assert torch.equal(v, want), k


def test_nest_and_flatten_are_inverse():
    flat = {"a.b.c": 1, "a.d": 2, "e": 3}
    assert nest(flat) == {"a": {"b": {"c": 1}, "d": 2}, "e": 3}
    assert flatten(nest(flat)) == flat
