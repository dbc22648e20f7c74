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
