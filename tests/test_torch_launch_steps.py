"""The port's launch steps, layouts and production meshes against the JAX
package's (``repro_torch.launch.steps`` / ``mesh``,
``repro_torch.distributed.sharding``, ``param_axes`` / ``nn.abstract_init``).

The reference's ``build_step`` needs its production meshes (256 and 512
devices), so it runs once, in a module-scoped subprocess with
``--xla_force_host_platform_device_count=512``, and dumps for every cell
of ``all_cells()`` on both meshes (and the cost variants 1 and 2 of a dense
LM, two MoE LMs, GraphCast, dr-bert-base and bert4rec on the single-pod
mesh): the cell name, kind, ``meta``, ``donate_argnums``, each abstract
argument's shape and dtype by key path, and each ``PartitionSpec`` of
``in_shardings`` / ``out_shardings`` by key path.  The port's
``build_step`` must give the same: integers exactly, floats within rtol
1e-12, dtypes by name, specs entry for entry (a one-name tuple is the
name, trailing ``None`` entries dropped, as ``P`` and the builders have
them).

``spec_for``, ``lm_batch_spec`` and ``cache_spec`` only read a mesh's
axis names and sizes, so they run in-process against the reference's
functions on a stand-in mesh of the production sizes.
"""

import json
import math
import os
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.distributed import sharding as jshd
from repro.models import graphcast as jgcast
from repro.models import nn as jnn
from repro.models import recsys as jrcs
from repro.models import transformer as jtfm
from repro_torch.configs import registry
from repro_torch.core import pytree
from repro_torch.distributed import compat
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import steps
from repro_torch.models import graphcast as gcast
from repro_torch.models import nn
from repro_torch.models import recsys as rcs
from repro_torch.models import transformer as tfm

CELLS = steps.all_cells()
COST_CELLS = [("qwen2-0.5b", "train_4k"), ("arctic-480b", "decode_32k"),
              ("deepseek-v2-lite-16b", "train_4k"), ("graphcast", "molecule"),
              ("dr-bert-base", "encode_corpus"), ("bert4rec", "train_batch")]
DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
               torch.int32: "int32", torch.bool: "bool"}

_DUMP = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax
    from repro.launch.mesh import make_production_mesh
    from repro.launch.steps import build_step, all_cells

    def key(path):
        return [getattr(k, "key", getattr(k, "idx", None)) for k in path]

    def spec_json(spec):
        out = [list(e) if isinstance(e, tuple) else e for e in spec]
        while out and out[-1] is None:
            out.pop()
        return out

    def shardings(tree):
        if tree is None:
            return None
        return [[key(p), spec_json(s.spec)] for p, s in
                jax.tree_util.tree_flatten_with_path(tree)[0]]

    def dump(spec):
        args = jax.tree_util.tree_flatten_with_path(spec.abstract_args)[0]
        return {"cell": spec.cell, "kind": spec.kind, "meta": spec.meta,
                "donate": list(spec.donate_argnums),
                "args": [[key(p), list(l.shape), str(l.dtype)]
                         for p, l in args],
                "in": shardings(spec.in_shardings),
                "out": shardings(spec.out_shardings)}

    cost_cells = json.loads(sys.argv[2])
    out = {}
    for multi in (0, 1):
        mesh = make_production_mesh(multi_pod=bool(multi))
        for a, s in all_cells():
            out[f"{multi}|{a}|{s}|full|1"] = dump(build_step(a, s, mesh))
    mesh = make_production_mesh()
    for a, s in cost_cells:
        for n in (1, 2):
            out[f"0|{a}|{s}|cost|{n}"] = dump(build_step(
                a, s, mesh, variant="cost", cost_layers=n))
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("launch_ref") / "ref.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", _DUMP, str(path),
                    json.dumps(COST_CELLS)], check=True, env=env,
                   timeout=600)
    with open(path) as f:
        return json.load(f)


def _spec_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _shardings(tree):
    if tree is None:
        return None
    return [[list(p), _spec_json(s.spec)]
            for p, s in pytree.tree_flatten_with_path(tree)]


def _dump(spec):
    return json.loads(json.dumps({
        "cell": spec.cell, "kind": spec.kind, "meta": spec.meta,
        "donate": list(spec.donate_argnums),
        "args": [[list(p), list(t.shape), DTYPE_NAMES[t.dtype]]
                 for p, t in pytree.tree_flatten_with_path(
                     spec.abstract_args)],
        "in": _shardings(spec.in_shardings),
        "out": _shardings(spec.out_shardings)}))


def _assert_same(got, want):
    assert set(got["meta"]) == set(want["meta"])
    for key, w in want["meta"].items():
        g = got["meta"][key]
        if isinstance(w, float):
            assert math.isclose(g, w, rel_tol=1e-12), (key, g, w)
        else:
            assert g == w and type(g) is type(w), (key, g, w)
    for field in ("cell", "kind", "donate", "args", "in", "out"):
        assert got[field] == want[field], field


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}/{s}" for a, s in CELLS])
def test_build_step_matches_reference(reference, arch, shape, multi_pod):
    mesh = launch_mesh.make_production_mesh(multi_pod=multi_pod)
    spec = steps.build_step(arch, shape, mesh)
    _assert_same(_dump(spec), reference[f"{int(multi_pod)}|{arch}|{shape}"
                                        "|full|1"])
    for t in pytree.tree_leaves(spec.abstract_args):
        assert t.device.type == "meta"


@pytest.mark.parametrize("cost_layers", [1, 2])
@pytest.mark.parametrize("arch,shape", COST_CELLS,
                         ids=[f"{a}/{s}" for a, s in COST_CELLS])
def test_cost_variants_match_reference(reference, arch, shape, cost_layers):
    spec = steps.build_step(arch, shape, launch_mesh.make_production_mesh(),
                            variant="cost", cost_layers=cost_layers)
    _assert_same(_dump(spec),
                 reference[f"0|{arch}|{shape}|cost|{cost_layers}"])


def test_all_cells_match_reference():
    assert steps.all_cells() == [tuple(c) for c in _ref_cells()]
    assert len(steps.all_cells()) == 43
    assert steps.all_cells(include_paper_arch=False) == \
        [c for c in CELLS if c[0] != "dr-bert-base"]


def _ref_cells():
    out = []
    for a in list(jregistry.ASSIGNED_ARCH_IDS) + ["dr-bert-base"]:
        out += [(a, s) for s in jregistry.get(a).shapes]
    return out


def test_opt_state_shardings_adamw_and_adafactor(reference):
    """The optimizer-state part of the train cells: AdamW's m / v take
    their param's spec; Adafactor's factored vr / vc (arctic-480b) take it
    with the dropped dim removed; the step counter is replicated."""
    mesh = launch_mesh.make_production_mesh()
    for arch, opt_name in (("qwen2-72b", "adamw"),
                           ("arctic-480b", "adafactor")):
        spec = steps.build_step(arch, "train_4k", mesh)
        assert spec.meta["optimizer"] == opt_name
        got = [e for e in _dump(spec)["in"] if e[0][0] == 1]
        want = [e for e in reference[f"0|{arch}|train_4k|full|1"]["in"]
                if e[0][0] == 1]
        assert got == want
        params_sh = dict(pytree.tree_flatten_with_path(spec.in_shardings[0]))
        opt_sh = dict(pytree.tree_flatten_with_path(spec.in_shardings[1]))
        assert opt_sh[("step",)].spec == shd.P()
        w2 = ("moe_layers", "moe", "w2")
        if opt_name == "adamw":
            leaf = ("dense_layers", "mlp", "w2")
            assert opt_sh[("m",) + leaf].spec == params_sh[leaf].spec
            assert opt_sh[("v",) + leaf].spec == params_sh[leaf].spec
        else:
            full = list(params_sh[w2].spec) + [None] * 4
            vr = opt_sh[("slots",) + w2 + ("vr",)].spec
            vc = opt_sh[("slots",) + w2 + ("vc",)].spec
            assert vr == shd.P(*full[:3]) and vc == shd.P(*(full[:2]
                                                            + full[3:4]))


# ---------------------------------------------------------------------------
# param_axes / abstract_init
# ---------------------------------------------------------------------------

_REF_INIT = {"lm": jtfm.init, "biencoder": jtfm.init, "recsys": jrcs.init,
             "gnn": jgcast.init}
_PORT_MODEL = {"lm": tfm, "biencoder": tfm, "recsys": rcs, "gnn": gcast}


def _as_lists(tree):
    if isinstance(tree, dict):
        return {k: _as_lists(v) for k, v in tree.items()}
    return list(tree)


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_param_axes_match_reference_abstract_init(arch, size):
    spec, jspec = registry.get(arch), jregistry.get(arch)
    cfg = getattr(spec, f"{size}_config")()
    jcfg = getattr(jspec, f"{size}_config")()
    want_shapes, want_axes = jnn.abstract_init(
        _REF_INIT[spec.family], jax.random.PRNGKey(0), jcfg)
    shapes, axes = nn.abstract_init(_PORT_MODEL[spec.family], cfg)
    assert axes == want_axes
    got = {p: (tuple(t.shape), DTYPE_NAMES[t.dtype], t.device.type)
           for p, t in pytree.tree_flatten_with_path(shapes)}
    want = {tuple(getattr(k, "key") for k in p):
            (tuple(s.shape), str(s.dtype), "meta")
            for p, s in jax.tree_util.tree_flatten_with_path(
                want_shapes)[0]}
    assert got == want


def test_abstract_init_allocates_nothing():
    cfg = registry.get("arctic-480b").full_config()
    shapes, _ = nn.abstract_init(tfm, cfg)
    leaves = pytree.tree_leaves(shapes)
    assert all(t.device.type == "meta" for t in leaves)
    # ~477 B parameters, none of them in memory
    assert sum(t.numel() for t in leaves) > 4e11


# ---------------------------------------------------------------------------
# the rules engine against the reference's, on stand-in meshes
# ---------------------------------------------------------------------------

MESH_SIZES = {"16x16": {"data": 16, "model": 16},
              "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _stand_in(name):
    sizes = MESH_SIZES[name]
    return types.SimpleNamespace(shape=dict(sizes),
                                 axis_names=tuple(sizes))


def _port_mesh(name):
    return launch_mesh.make_production_mesh(multi_pod=name == "2x16x16")


def _norm(spec):
    out = [list(e) if isinstance(e, tuple) else e for e in spec]
    while out and out[-1] is None:
        out.pop()
    return out


_RULES = {"train": (shd.lm_train_rules, jshd.lm_train_rules),
          "serve": (shd.lm_serve_rules, jshd.lm_serve_rules),
          "fsdp": (shd.fsdp_only_rules, jshd.fsdp_only_rules)}


@pytest.mark.parametrize("mesh_name", list(MESH_SIZES))
@pytest.mark.parametrize("rules", list(_RULES))
def test_spec_for_matches_reference(rules, mesh_name):
    """Every parameter leaf of every full config, plus shapes built to hit
    the divisibility fallback (30522 rows, 7 columns), the leftmost-wins
    dedup (experts and mlp both on "model") and leading stack dims."""
    port_rules, ref_rules = _RULES[rules][0](), _RULES[rules][1]()
    mesh, ref_mesh = _port_mesh(mesh_name), _stand_in(mesh_name)
    cases = [((30522, 768), ("vocab", "embed")),
             ((7, 16), ("embed", "mlp")),
             ((128, 4096, 1408), ("expert", "embed", "mlp")),
             ((27, 3, 64, 32), ("expert", "embed", "mlp")),
             ((24, 896), ("embed",)), ((5,), ("unknown",)), ((), ())]
    for arch in registry.ARCH_IDS:
        spec = registry.get(arch)
        shapes, axes = nn.abstract_init(_PORT_MODEL[spec.family],
                                        spec.full_config())
        flat_axes = dict(_flat_axes(axes))
        cases += [(tuple(t.shape), flat_axes[p])
                  for p, t in pytree.tree_flatten_with_path(shapes)]
    for shape, axes in cases:
        got = shd.spec_for(shape, axes, port_rules, mesh)
        want = jshd.spec_for(shape, axes, ref_rules, ref_mesh)
        assert _norm(got) == _norm(want), (shape, axes)
        assert isinstance(got, shd.PartitionSpec)


def _flat_axes(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_axes(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("mesh_name", list(MESH_SIZES))
def test_lm_batch_and_cache_specs_match_reference(mesh_name):
    mesh, ref_mesh = _port_mesh(mesh_name), _stand_in(mesh_name)
    batches = sorted({s["global_batch"]
                      for s in registry.LM_SHAPES.values()} | {1, 8, 24})
    seqs = sorted({s["seq_len"] for s in registry.LM_SHAPES.values()}
                  | {100, 48})
    for B in batches:
        assert _norm(shd.lm_batch_spec(mesh, B)) == \
            _norm(jshd.lm_batch_spec(ref_mesh, B))
        for T in seqs:
            for shape in ((24, B, T, 2, 64), (26, B, T, 512)):
                assert _norm(shd.cache_spec(mesh, shape, B)) == \
                    _norm(jshd.cache_spec(ref_mesh, shape, B)), (B, T)


def test_partition_spec_and_named_sharding():
    P = shd.P
    assert P(("data",), None, None) == P("data") == ("data",)
    assert P(None, ("pod", "data")) == (None, ("pod", "data"))
    assert P() == () and repr(P("model")) == "PartitionSpec('model',)"
    mesh = launch_mesh.make_production_mesh(multi_pod=True)
    ns = shd.NamedSharding(mesh, P(("pod", "data"), None, "model"))
    assert ns.shards_of(3) == [32, 1, 16]
    assert ns.shard_shape((256, 3, 100)) == (8, 3, 7)


def test_tree_shardings_match_reference_rules(reference):
    """tree_shardings over qwen2-72b's serving params is the reference's
    (the decode cell's first argument) and keys every leaf."""
    mesh = launch_mesh.make_production_mesh()
    cfg = registry.get("qwen2-72b").full_config()
    shapes, axes = nn.abstract_init(tfm, cfg)
    tree = shd.tree_shardings(shapes, axes, shd.lm_serve_rules(), mesh)
    got = [[[0] + list(p), _spec_json(s.spec)]
           for p, s in pytree.tree_flatten_with_path(tree)]
    want = [e for e in reference["0|qwen2-72b|decode_32k|full|1"]["in"]
            if e[0][0] == 0]
    assert got == want


# ---------------------------------------------------------------------------
# production meshes, meta devices, and the decode step's index
# ---------------------------------------------------------------------------


def test_production_mesh_is_a_meta_layout():
    single = launch_mesh.make_production_mesh()
    multi = launch_mesh.make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512 and multi.is_meta and single.is_meta
    assert compat._checked("meta") == torch.device("meta")
    cpu_mesh = launch_mesh.make_production_mesh(device="cpu")
    assert not cpu_mesh.is_meta and cpu_mesh.home == torch.device("cpu")


def test_placements_refuse_data_on_a_meta_mesh():
    mesh = launch_mesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="meta devices describes a layout"):
        shd.rows_sharding(mesh).put(torch.zeros(256, 4))
    with pytest.raises(RuntimeError, match="meta devices describes a layout"):
        shd.rows_sharding(mesh).put(np.zeros((256, 4), np.float32))
    with pytest.raises(RuntimeError, match="meta devices describes a layout"):
        shd.replicated_sharding(mesh).put({"w": torch.zeros(3)})
    # meta tensors split over a meta mesh move nothing: the dry run's path
    rows = shd.rows_sharding(mesh).put(torch.empty(512, 4, device="meta"))
    assert len(rows.shards) == 256 and rows.shape == (512, 4)


def test_decode_index_binds_to_last_position(monkeypatch):
    """Divergence by design: the decode cell keeps the reference's 0-d
    int32 ``index`` slot, and its step writes position ``seq_len - 1``
    whatever value the slot holds.  Checked at the smoke config (f32
    compute over the cell's bf16 weights) against the port's and the
    reference's ``decode_step`` at that index."""
    import dataclasses

    import jax.numpy as jnp
    from repro.configs import qwen2_0_5b as jqwen
    from repro_torch.configs import qwen2_0_5b
    cfg = dataclasses.replace(qwen2_0_5b.smoke_config(),
                              compute_dtype=torch.float32)
    monkeypatch.setattr(qwen2_0_5b, "full_config", lambda: cfg)
    monkeypatch.setitem(registry.LM_SHAPES, "decode_32k",
                        {"kind": "decode", "seq_len": 12, "global_batch": 2})
    mesh = compat.make_mesh((1, 1), ("data", "model"),
                            [torch.device("cpu")])
    spec = steps.build_step("qwen2-0.5b", "decode_32k", mesh)
    idx = spec.abstract_args[3]
    assert idx.shape == () and idx.dtype == torch.int32
    rng = np.random.default_rng(0)
    params = tfm.init_numpy(cfg, seed=0)
    kv = (cfg.n_layers, 2, 12, cfg.n_kv_heads, cfg.head_dim)
    cache = {"dense": {k: rng.standard_normal(kv, dtype=np.float32)
                       for k in ("k", "v")}, "moe": None}
    token = rng.integers(1, cfg.vocab_size, (2, 1)).astype(np.int32)

    def port_args(index):
        p = pytree.tree_map(
            lambda a: torch.from_numpy(a).to(torch.bfloat16), params)
        c = pytree.tree_map(lambda a: torch.from_numpy(a.copy()), cache)
        return p, c, torch.from_numpy(token), torch.tensor(
            index, dtype=torch.int32)

    logits, _ = spec.fn(*port_args(3))
    again, _ = spec.fn(*port_args(7))
    p, c, tok, _ = port_args(0)
    want, _ = tfm.decode_step(p, cfg, c, tok, 11)
    assert torch.equal(logits, want) and torch.equal(again, want)
    jcfg = dataclasses.replace(jqwen.smoke_config(),
                               compute_dtype=jnp.float32)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                params)
    jc = {"dense": {k: jnp.asarray(v) for k, v in cache["dense"].items()},
          "moe": None}
    ref, _ = jtfm.decode_step(jp, jcfg, jc, jnp.asarray(token),
                              jnp.asarray(11, jnp.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
