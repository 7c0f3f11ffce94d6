"""The port's sharding rules against the JAX package's, on the CPU.

* `param_specs` (the params, AdamW's and Adafactor's state, with and
  without FSDP), `batch_specs` (the train inputs), `cache_specs` (the
  decode_32k cache) and `legalize`, equal as tuples, leaf by leaf, to the
  JAX package's for all ten archs on the (16, 16) and (2, 16, 16)
  abstract meshes; every legalized sharded dim divides
  (tests/test_substrate.py:212-250, mamba2's vocab 50280 included);
* `PartitionSpec` canonicalized as JAX's is;
* `to_placements` on hand-made cases, its raises, and a DTensor laid
  out by `to_named` on a one-rank (data, model) mesh.
"""
import jax
import pytest
import torch
import torch.distributed as tdist
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as JARCHS
from repro.configs import RunConfig as JRunConfig
from repro.configs import SHAPES as JSHAPES
from repro.launch.mesh import abstract_mesh as jabstract_mesh
from repro.launch.specs import decode_input_specs as jdecode_input_specs
from repro.launch.specs import param_shapes as jparam_shapes
from repro.launch.specs import train_input_specs as jtrain_input_specs
from repro.optim import adafactor_init as jadafactor_init
from repro.optim import adamw_init as jadamw_init
from repro.sharding import rules as jrules

from repro_torch.configs import ARCHS, SHAPES, RunConfig
from repro_torch.launch.mesh import abstract_mesh, small_mesh
from repro_torch.launch.specs import (decode_input_specs, param_shapes,
                                      train_input_specs)
from repro_torch.optim import adafactor_init, adamw_init
from repro_torch.sharding import (NamedSharding, P, PartitionSpec,
                                  batch_specs, cache_specs, legalize,
                                  param_specs, to_named, to_placements)

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _flat_ours(tree, prefix=""):
    """{path: leaf} of a port tree whose leaves are tensors or specs."""
    if isinstance(tree, PartitionSpec) or not isinstance(
            tree, (dict, list, tuple)):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat_ours(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _key(p):
    return str(p.key) if hasattr(p, "key") else str(p.idx)


def _flat_ref(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {"/".join(_key(p) for p in path): leaf for path, leaf in leaves}


def _same_specs(ours, ref) -> None:
    a, b = _flat_ours(ours), _flat_ref(ref)
    assert set(a) == set(b)
    diffs = [(k, tuple(a[k]), tuple(b[k])) for k in a
             if tuple(a[k]) != tuple(b[k])]
    assert not diffs, diffs[:10]
    assert all(isinstance(v, PartitionSpec) for v in a.values())


def _divides(specs, shapes, sizes) -> None:
    flat_sp, flat_sh = _flat_ours(specs), _flat_ours(shapes)
    for path, spec in flat_sp.items():
        for size, ax in zip(flat_sh[path].shape, spec):
            if ax is None:
                continue
            total = 1
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                total *= sizes[a]
            assert size % total == 0, (path, flat_sh[path].shape, spec)


@pytest.fixture(scope="module")
def trees():
    """Per arch: (ours, the JAX package's) shape trees of the params, the
    optimizer states, the train_4k inputs and the decode_32k cache."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg, jcfg = ARCHS[arch], JARCHS[arch]
            p, jp = param_shapes(cfg), jparam_shapes(jcfg)
            cache[arch] = {
                "params": (p, jp),
                "adamw": (adamw_init(p), jax.eval_shape(jadamw_init, jp)),
                "adafactor": (adafactor_init(p),
                              jax.eval_shape(jadafactor_init, jp)),
                "batch": (train_input_specs(cfg, SHAPES["train_4k"]),
                          jtrain_input_specs(jcfg, JSHAPES["train_4k"])),
                "cache": (decode_input_specs(cfg, RunConfig(),
                                             SHAPES["decode_32k"])["cache"],
                          jdecode_input_specs(jcfg, JRunConfig(),
                                              JSHAPES["decode_32k"])["cache"]),
            }
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", list(ARCHS))
def test_specs_equal_reference(arch, trees):
    t = trees(arch)
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    for fsdp in (True, False):
        rc, jrc = RunConfig(fsdp=fsdp), JRunConfig(fsdp=fsdp)
        for kind in ("params", "adamw", "adafactor"):
            ours, ref = t[kind]
            _same_specs(param_specs(ours, cfg, rc),
                        jrules.param_specs(ref, jcfg, jrc))
    for name, (shape, axes) in MESHES.items():
        mesh, jmesh = abstract_mesh(shape, axes), jabstract_mesh(shape, axes)
        sizes = dict(zip(axes, shape))
        for kind in ("params", "adamw", "adafactor"):
            ours, ref = t[kind]
            sp = param_specs(ours, cfg, RunConfig())
            jsp = jrules.param_specs(ref, jcfg, JRunConfig())
            fixed = legalize(sp, ours, mesh)
            _same_specs(fixed, jrules.legalize(jsp, ref, jmesh))
            _divides(fixed, ours, sizes)
        ours, ref = t["batch"]
        _same_specs(batch_specs(ours, mesh), jrules.batch_specs(ref, jmesh))
        ours, ref = t["cache"]
        for seq in (True, False):
            sp = cache_specs(ours, mesh, cfg, seq_shard=seq)
            jsp = jrules.cache_specs(ref, jmesh, jcfg, seq_shard=seq)
            _same_specs(sp, jsp)
            _same_specs(legalize(sp, ours, mesh),
                        jrules.legalize(jsp, ref, jmesh))


def test_mamba_vocab_not_sharded_16way(trees):
    """mamba2's vocab 50280 % 16 != 0: the axis is dropped, not crashed
    on."""
    mesh = abstract_mesh((16, 16), ("data", "model"))
    shapes = trees("mamba2-780m")["params"][0]
    specs = legalize(param_specs(shapes, ARCHS["mamba2-780m"], RunConfig()),
                     shapes, mesh)
    assert specs["embed"][0] is None
    assert specs["embed"] == P(None, "data")


def test_batch_specs_scalars_and_singletons():
    mesh = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    tree = {"pos": torch.empty((), device="meta"),
            "one": torch.empty((1, 7), device="meta"),
            "tok": torch.empty((64, 7), device="meta")}
    got = batch_specs(tree, mesh)
    assert got == {"pos": P(), "one": P(None, None),
                   "tok": P(("pod", "data"), None)}


def test_partition_spec_canonical_like_jax():
    for entries in ((("data",), None), ((), "model"),
                    (("pod", "data"), None, "model"), (None,), ()):
        assert tuple(P(*entries)) == tuple(JP(*entries))
    s = P(("pod", "data"), None, "model")
    assert len(s) == 3 and s[:-1] == (("pod", "data"), None)
    assert s[-1:] == ("model",) and isinstance(P(*s[:-1]), PartitionSpec)
    assert repr(P("data", None)) == "PartitionSpec('data', None)"


def test_to_placements_hand_made():
    from torch.distributed.tensor import Replicate, Shard
    mesh = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    R = Replicate()
    cases = {P(("pod", "data"), None): (Shard(0), Shard(0), R),
             P(None, "model"): (R, R, Shard(1)),
             P(("pod", "model"), "data"): (Shard(0), Shard(1), Shard(0)),
             P(None, None): (R, R, R),
             P(): (R, R, R),
             P("data", ("pod",)): (Shard(1), Shard(0), R)}
    for spec, want in cases.items():
        assert to_placements(spec, mesh) == want, spec
    for bad, match in ((P(("data", "pod")), "mesh order"),
                       (P(("model", "data"), None), "mesh order"),
                       (P("data", "data"), "twice"),
                       (P("nope"), "not in mesh axes")):
        with pytest.raises(ValueError, match=match):
            to_placements(bad, mesh)


def test_to_named_on_a_device_mesh(tmp_path):
    """A one-rank (data, model) DeviceMesh under gloo: to_named legalizes
    against the shapes and gives placements that distribute_tensor
    accepts, and the DTensor round-trips."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    store = tdist.FileStore(str(tmp_path / "store"), 1)
    tdist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        mesh = small_mesh(1, 1)
        shapes = {"w": torch.arange(12.0).reshape(3, 4),
                  "v": [torch.arange(5.0)]}
        specs = {"w": P("data", "model"), "v": [P(("data", "model"))]}
        named = to_named(mesh, specs, shapes)
        assert isinstance(named["w"], NamedSharding)
        assert named["w"].spec == P("data", "model")
        assert named["w"].placements == (Shard(0), Shard(1))
        assert named["v"][0].placements == (Shard(0), Shard(0))
        for name, t in (("w", shapes["w"]), ("v", shapes["v"][0])):
            ns = named[name] if name == "w" else named[name][0]
            dt = distribute_tensor(t, mesh, list(ns.placements))
            assert torch.equal(dt.full_tensor(), t)
        rep = to_named(mesh, {"x": P(None)})["x"]
        assert rep.placements == (Replicate(), Replicate())
    finally:
        tdist.destroy_process_group()


def test_legalize_drops_non_dividing_axes():
    mesh = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    shapes = {"a": torch.empty((6, 32, 10), device="meta"),
              "b": torch.empty((64, 50280), device="meta")}
    specs = {"a": P(("pod", "data"), "model", "data"),
             "b": P(("pod", "data"), "model")}
    got = legalize(specs, shapes, mesh)
    assert got == {"a": P(None, "model", None),
                   "b": P(("pod", "data"), None)}
