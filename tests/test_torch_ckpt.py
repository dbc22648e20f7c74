"""The port's checkpoint reader on checkpoints the JAX package wrote.

The JAX side saves f32 and bf16 parameter trees with ``repro.ckpt.save``;
the port restores them in a subprocess where ``jax``, ``ml_dtypes`` and
``repro`` cannot be imported (as on the GPU machine), and every leaf must
come back bit for bit.  A save -> restore round trip of the port itself and
the mismatch checks are tested here too.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs import dr_bert_base as jcfg_mod
from repro.models import nn as jnn
from repro.models import transformer as jtfm
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import dr_bert_base as tcfg_mod
from repro_torch.models import transformer as ttfm

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

#: prepended to a child script: refuse to import jax, ml_dtypes or repro
BLOCK = textwrap.dedent("""
    import sys
    class _Block:
        def find_spec(self, name, path=None, target=None):
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "ml_dtypes", "repro"):
                raise ImportError(f"{name} is blocked in this test")
            return None
    sys.meta_path.insert(0, _Block())
""")


def _jax_tree(dtype):
    tree = jnn.materialize(jtfm.init(jax.random.PRNGKey(0),
                                     jcfg_mod.smoke_config()))
    return jax.tree_util.tree_map(lambda x: np.asarray(x.astype(dtype)),
                                  tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_restore_jax_checkpoint_without_jax(tmp_path, dtype):
    tree = _jax_tree(getattr(jnp, dtype))
    jckpt.save(str(tmp_path / "ckpts"), 7, {"params": tree},
               extra={"note": "jax"})
    out = tmp_path / "leaves.npz"
    script = BLOCK + textwrap.dedent(f"""
        import numpy as np
        from repro_torch.ckpt import checkpoint as ckpt
        from repro_torch.configs import dr_bert_base
        from repro_torch.models import transformer as tfm
        cfg = dr_bert_base.smoke_config()
        state, extra = ckpt.restore({str(tmp_path / 'ckpts')!r},
                                    template={{"params": tfm.param_shapes(cfg)}})
        assert extra == {{"note": "jax"}}, extra
        leaves = {{}}
        for path, t in ckpt.flatten(state):
            assert str(t.dtype) == "torch.{dtype}", t.dtype
            leaves[path] = t.float().numpy()
        np.savez({str(out)!r}, **leaves)
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = np.load(out)
    want = dict(ckpt.flatten({"params": tree}))
    assert sorted(got.files) == sorted(want)
    for path, arr in want.items():
        np.testing.assert_array_equal(got[path], arr.astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_save_restore_round_trip(tmp_path, dtype):
    cfg = tcfg_mod.smoke_config()
    params = {k: v for k, v in ckpt.flatten(ttfm.params_from_numpy(
        ttfm.init_numpy(cfg, 3)))}
    tree = ttfm.params_from_numpy(ttfm.init_numpy(cfg, 3))
    tree = jax.tree_util.tree_map(lambda t: t.to(dtype), tree)
    ckpt.save(str(tmp_path), 1, {"params": tree}, extra={"step": 1})
    ckpt.save(str(tmp_path), 5, {"params": tree})
    assert ckpt.list_steps(str(tmp_path)) == [1, 5]
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert ckpt.read_extra(str(tmp_path), 1) == {"step": 1}
    state, _ = ckpt.restore(str(tmp_path), 1,
                            template={"params": ttfm.param_shapes(cfg)})
    for path, t in ckpt.flatten(state["params"]):
        assert t.dtype == dtype
        assert torch.equal(t, params[path].to(dtype))


def test_uncommitted_and_mismatched_checkpoints_raise(tmp_path):
    cfg = tcfg_mod.smoke_config()
    tree = {"params": ttfm.init_numpy(cfg, 0)}
    final = ckpt.save(str(tmp_path), 2, tree)
    template = {"params": ttfm.param_shapes(cfg)}
    bigger = {"params": ttfm.param_shapes(tcfg_mod.full_config())}
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), 2, template=bigger)
    with pytest.raises(ValueError, match="key paths"):
        ckpt.restore(str(tmp_path), 2, template=template["params"])
    os.remove(os.path.join(final, ckpt.COMMIT_MARKER))
    assert not ckpt.is_committed(final) and ckpt.list_steps(str(tmp_path)) \
        == []
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), 2, template=template)


def test_flatten_order_matches_jax():
    tree = _jax_tree(jnp.float32)
    jleaves = jax.tree_util.tree_leaves(tree)
    tleaves = [leaf for _, leaf in ckpt.flatten(tree)]
    assert len(jleaves) == len(tleaves)
    assert all(a is b for a, b in zip(jleaves, tleaves))


# ---------------------------------------------------------------------------
# The reference trainer's checkpoints: params + AdamW state, by key path
# ---------------------------------------------------------------------------


def test_restore_params_of_a_trainer_shaped_checkpoint(tmp_path):
    """``{"params", "opt_state"}`` as ``repro.train.trainer`` saves it: the
    port restores the ``params`` subtree bit for bit equal to what
    ``repro.ckpt.restore`` reads."""
    from repro.train import optim
    params = jnn.materialize(jtfm.init(jax.random.PRNGKey(4),
                                       jcfg_mod.smoke_config()))
    state = {"params": params, "opt_state": optim.adamw(1e-3).init(params)}
    root = str(tmp_path / "ckpts")
    jckpt.save(root, 10, state, extra={"step": 10})
    n_saved = len(jax.tree_util.tree_leaves(state))
    cfg = tcfg_mod.smoke_config()
    template = {"params": ttfm.param_shapes(cfg)}
    assert n_saved > len(ckpt.flatten(template))
    got, extra = ckpt.restore(root, 10, template=template)
    assert extra == {"step": 10}
    want, _ = jckpt.restore(root, 10)
    want = dict(ckpt.flatten({"params": want["params"]}))
    flat = ckpt.flatten(got)
    assert [p for p, _ in flat] == sorted(want) == [p for p, _ in flat]
    for path, t in flat:
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[path]))


_TREES = {
    "nested_dict": {"b": {"y": 1, "x": {"q": 2}}, "a": 3},
    "list_tuple_none": {"p": [1, (2, None, [3, 4]), None], "o": (5,)},
    "empty_nodes": {"e": {}, "l": [], "t": (), "n": None, "v": 7},
    "leaf": 1,
    "top_list": [{"a": 1}, [2, 3]],
}


@pytest.mark.parametrize("name", sorted(_TREES))
def test_treedef_keypaths_equal_jax(name):
    tree = _TREES[name]
    proto = jax.tree_util.tree_structure(tree).serialize_using_proto()
    want = [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert ckpt.treedef_keypaths(proto.hex()) == want
    assert ckpt.treedef_keypaths(proto) == want


@pytest.mark.parametrize("node", [b"\x10\x06", b"\x10\x07", b"\x10\x00",
                                  b"\x08\x01\x10\x09"])
def test_treedef_unsupported_node_kinds_raise(node):
    leaf = b"\x0a\x02\x10\x01"                    # one leaf node
    proto = leaf + b"\x0a" + bytes([len(node)]) + node
    with pytest.raises(ValueError, match="not supported"):
        ckpt.treedef_keypaths(proto)


def test_treedef_malformed_raises():
    good = jax.tree_util.tree_structure({"a": [1, 2]}) \
        .serialize_using_proto()
    with pytest.raises(ValueError, match="truncated"):
        ckpt.treedef_keypaths(good[:-1])
    with pytest.raises(ValueError, match="outside"):
        ckpt.treedef_keypaths(good[:-3])          # the key's string is gone
    with pytest.raises(ValueError, match="roots"):
        ckpt.treedef_keypaths(b"\x0a\x02\x10\x01" * 2)   # two leaves, no root


def test_restore_missing_key_path_raises(tmp_path):
    cfg = tcfg_mod.smoke_config()
    params = jnn.materialize(jtfm.init(jax.random.PRNGKey(0),
                                       jcfg_mod.smoke_config()))
    jckpt.save(str(tmp_path), 3, {"params": params})
    template = {"params": ttfm.param_shapes(cfg)}
    with pytest.raises(ValueError, match="key paths"):
        ckpt.restore(str(tmp_path), 3, template={"model": template["params"]})
    extra = {"params": dict(template["params"], extra_leaf=(3,))}
    with pytest.raises(ValueError, match="extra_leaf"):
        ckpt.restore(str(tmp_path), 3, template=extra)


# each case: the steps saved, then gc calls in turn (kwargs; "save" adds a
# step between calls), as tests/test_ckpt.py and tests/test_control.py
# drive the reference's gc_checkpoints
_GC_CASES = {
    "keep_last_protect": ((1, 2, 3, 4, 5),
                          [dict(keep_last=2, protect={2})]),
    "keep_set_then_keep_last": ((1, 2, 3, 4),
                                [dict(keep={1, 4}, protect={2}),
                                 dict(keep_last=1)]),
    "horizon_spares_newer": ((1, 2, 3),
                             [{"save": 4}, dict(keep={3}, protect={2}),
                              dict(keep=set())]),
    "explicit_horizon": ((1, 2, 3, 4, 5),
                         [dict(keep={2}, horizon=4), dict(keep_last=0)]),
    "keep_list_with_protect": ((10, 20, 30),
                               [dict(keep=[30], protect={10})]),
}


@pytest.mark.parametrize("case", sorted(_GC_CASES))
def test_gc_checkpoints_matches_reference(tmp_path, case):
    steps, calls = _GC_CASES[case]
    roots = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    tree = {"w": np.zeros((2,), np.float32)}
    for s in steps:
        jckpt.save(roots["jax"], s, tree)
        ckpt.save(roots["port"], s, tree)
    for call in calls:
        if "save" in call:
            jckpt.save(roots["jax"], call["save"], tree)
            ckpt.save(roots["port"], call["save"], tree)
            continue
        want = jckpt.gc_checkpoints(roots["jax"], **call)
        got = ckpt.gc_checkpoints(roots["port"], **call)
        assert got == want, call
        assert ckpt.list_steps(roots["port"]) == \
            jckpt.list_steps(roots["jax"])
