"""PyTorch port vs the JAX reference: meshes, sharding specs and the
population mesh (the port's counterpart of ``tests/test_launch.py``).

The production meshes (16x16, 2x16x16) live on the meta device in the port;
the reference's ``resolve_spec`` is called on stub meshes (an object with
``axis_names`` and ``devices = np.empty(shape)``, all that its
``_mesh_axis_sizes`` reads), so neither package needs 256 devices.

Tolerances: layouts are compared as tuples, exactly; decoded rows bit for
bit (the f32 store's against the reference's ``device_ef``, the packed
store's against its own ``gather_ef``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.launch import mesh as jmesh_lib
from repro.launch import specs as jspecs
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import griffin as jgriffin
from repro.models import transformer as jtransformer
from repro_torch.configs import qwen2_5_3b, recurrentgemma_2b
from repro_torch.core import prng
from repro_torch.core.tree import tree_items
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.models import common
from repro_torch.models import griffin, transformer
from repro_torch.models.common import NamedSharding, PartitionSpec as P

torch.set_num_threads(1)


class StubMesh:
    """What the reference's ``resolve_spec`` reads of a mesh."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.devices = np.empty(shape)


def test_compat_make_mesh_shapes_and_devices():
    m = mesh_lib.compat_make_mesh((2, 3), ("data", "model"))
    assert m.axis_names == ("data", "model")
    assert m.devices.shape == (2, 3) and m.devices.size == 6
    assert all(d == torch.device("meta") for d in m.devices.flat)
    with pytest.raises(ValueError, match="differ in length"):
        mesh_lib.compat_make_mesh((2, 3), ("data",))


def test_make_production_mesh_shapes():
    pod = mesh_lib.make_production_mesh()
    multi = mesh_lib.make_production_mesh(multi_pod=True)
    assert (pod.devices.shape, pod.axis_names) == ((16, 16), ("data", "model"))
    assert (multi.devices.shape, multi.axis_names) == ((2, 16, 16), ("pod", "data", "model"))
    assert pod.devices.size == 256 and multi.devices.size == 512


def test_make_host_mesh_on_the_cpu():
    m = mesh_lib.make_host_mesh(device="cpu")
    assert m.axis_names == ("data", "model")
    assert m.devices.shape == (1, 1)
    with pytest.raises(ValueError, match="needs 2 cpu devices"):
        mesh_lib.make_host_mesh(2, 1, device="cpu")


def test_cuda_meshes_without_a_card_name_the_cpu():
    if torch.cuda.is_available():
        assert mesh_lib.make_host_mesh().devices.flat[0].type == "cuda"
        return
    for make in (mesh_lib.make_host_mesh, mesh_lib.make_population_mesh):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_make_population_mesh_clamps():
    m = mesh_lib.make_population_mesh(device="cpu")
    assert m.axis_names == ("clients",)
    assert m.devices.size == 1
    # logical shard counts beyond the device count clamp, never raise
    assert mesh_lib.make_population_mesh(num_shards=10_000, device="cpu").devices.size == 1
    assert mesh_lib.make_population_mesh(num_shards=1, device="cpu").devices.size == 1
    assert mesh_lib.make_population_mesh(num_shards=4, device="meta").devices.size == 4


def test_population_sharding_fallbacks():
    """No 'clients' axis, a 1-wide axis, or a non-dividing leading dim all
    fall back to replication; a dividing leading dim partitions axis 0."""
    host = mesh_lib.make_host_mesh(device="cpu")
    assert specs_lib.population_sharding(host, 2, 8).spec == P()
    pop = mesh_lib.make_population_mesh(device="cpu")
    sh = specs_lib.population_sharding(pop, 3, 8)
    assert isinstance(sh, NamedSharding) and sh.spec == P()
    four = mesh_lib.make_population_mesh(num_shards=4, device="meta")
    assert specs_lib.population_sharding(four, 3, 8).spec == P("clients", None, None)
    assert specs_lib.population_sharding(four, 3, 8).shard_shape((8, 2, 3)) == (2, 2, 3)
    assert specs_lib.population_sharding(four, 3, 5).spec == P()
    assert specs_lib.population_sharding(four, 2).spec == P("clients", None)


def test_annotate_population_places_tree():
    pop = mesh_lib.make_population_mesh(device="cpu")
    tree = dict(a=np.zeros((8, 3), np.float32), b=np.zeros((8,), np.float32))
    placed = specs_lib.annotate_population(tree, pop)
    for k, v in placed.items():
        assert isinstance(v.sharding, NamedSharding)
        assert v.sharding.mesh.axis_names == ("clients",)
        assert v.value.device.type == "cpu" and v.shape == tree[k].shape


def _specs_by_path(specs):
    return dict(tree_items(specs))


@pytest.mark.parametrize("arch", [qwen2_5_3b, recurrentgemma_2b], ids=lambda a: a.ID)
@pytest.mark.parametrize("shape", [(16, 16), (2, 16, 16)], ids=["pod", "multipod"])
def test_resolve_spec_matches_reference_on_every_leaf(arch, shape):
    """Every leaf of ``param_specs`` at full width: the port's storage spec
    (through ``annotate_tree`` on a meta init) equals the reference's
    ``resolve_spec`` on the same stub mesh, and the shard shapes follow."""
    axes = ("pod", "data", "model")[-len(shape):]
    stub = StubMesh(shape, axes)
    jfam = dict(transformer=jtransformer, griffin=jgriffin)[arch.FAMILY]
    fam = dict(transformer=transformer, griffin=griffin)[arch.FAMILY]
    cfg = arch.config()
    jcfg = jfam.__dict__[type(cfg).__name__](**dataclasses.asdict(cfg))
    jshapes = jax.eval_shape(lambda k: jfam.init(k, jcfg), jax.random.PRNGKey(0))
    params = fam.init(prng.PRNGKey(0), cfg, "meta")
    mesh = mesh_lib.compat_make_mesh(shape, axes)
    ann = specs_lib.annotate_tree(params, fam.param_specs(cfg), mesh)
    jspecs_by_path = _specs_by_path(jfam.param_specs(jcfg))
    leaves = list(tree_items(ann))
    assert len(leaves) == len(jspecs_by_path) and len(leaves) > 10
    for path, placed in leaves:
        jleaf = jshapes
        for k in path:
            jleaf = jleaf[k]
        assert tuple(placed.shape) == tuple(jleaf.shape), path
        jspec = jspecs_by_path[path]
        want = jcommon.resolve_spec(jcommon._pad_spec(jspec.storage, len(jleaf.shape)),
                                    jleaf.shape, stub)
        got = placed.sharding.spec
        assert tuple(got) == tuple(want), (path, got, want)
        assert got == common.resolve_spec(common._pad_spec(jspec.storage, placed.value.ndim),
                                          placed.shape, stub)
        sizes = dict(zip(axes, shape))
        per_dim = [1 if e is None else sizes[e] if isinstance(e, str)
                   else int(np.prod([sizes[a] for a in e])) for e in got]
        per_dim += [1] * (placed.value.ndim - len(per_dim))
        assert placed.sharding.shard_shape(placed.shape) == tuple(
            d // n for d, n in zip(placed.shape, per_dim))


def test_resolve_spec_rule_cases():
    """Mesh axes tried in order, divisibility wins; an axis used once."""
    stub = StubMesh((2, 16, 16), ("pod", "data", "model"))
    for logical, shape in [(("batch", None), (32, 7)), (("batch", None), (16, 7)),
                           (("batch", None), (1, 7)), (("fsdp", "tensor"), (2048, 256)),
                           (("fsdp", "fsdp"), (64, 64)), ((None, "kv_seq", "tensor"), (4, 32, 2)),
                           (("replicated",), (5,)), (("unknown",), (8,))]:
        assert tuple(common.resolve_spec(logical, shape, stub)) == tuple(
            jcommon.resolve_spec(logical, shape, stub)), (logical, shape)
    assert common.resolve_spec(("batch",), (8,)) == P()  # no active mesh: replicated


def test_shard_hint_is_identity_and_checks_rank_under_a_mesh():
    x = torch.zeros((2, 3))
    assert common.shard_hint(x, "batch") is x  # no mesh: the identity, unchecked
    mesh = mesh_lib.make_production_mesh()
    with common.activate_mesh(mesh) as m:
        assert m is mesh and common.current_mesh() is mesh
        assert common.shard_hint(x, "batch", None) is x
        with pytest.raises(ValueError, match="2-d tensor"):
            common.shard_hint(x, "batch")
        assert common.named_sharding(("batch", None), (32, 3)).spec == P("data", None)
    assert common.current_mesh() is None


@pytest.mark.parametrize("family", ["transformer", "griffin"])
def test_decode_state_axes_match_reference(family):
    cfg = (qwen2_5_3b if family == "transformer" else recurrentgemma_2b).config()
    fam = dict(transformer=transformer, griffin=griffin)[family]
    state = fam.init_decode_state(cfg, 2, 64, device="meta")
    got = specs_lib.decode_state_axes(family, cfg, state)
    want = jspecs.decode_state_axes(family, None, dict(extra_rec=None)
                                    if family == "griffin" else None)
    if family == "transformer":
        assert isinstance(want, jattn.KVCache)
        assert {f.name: getattr(got, f.name) for f in dataclasses.fields(got)} == want._asdict()
    else:
        assert got == want


def test_annotate_cache_layouts_on_the_production_mesh():
    """The port's cache layout against the reference's rule, leaf by leaf."""
    stub = StubMesh((16, 16), ("data", "model"))
    mesh = mesh_lib.make_production_mesh()
    for family, arch in (("transformer", qwen2_5_3b), ("griffin", recurrentgemma_2b)):
        cfg = arch.config()
        fam = dict(transformer=transformer, griffin=griffin)[family]
        state = fam.init_decode_state(cfg, 128, 32_768, device="meta")
        ann = specs_lib.annotate_cache(state, family, cfg, mesh)
        axes = specs_lib.decode_state_axes(family, cfg, state)
        flat = ({f.name: getattr(ann, f.name) for f in dataclasses.fields(ann)}
                if family == "transformer" else ann)
        flat_axes = ({f.name: getattr(axes, f.name) for f in dataclasses.fields(axes)}
                     if family == "transformer" else axes)
        n = 0
        for path, leaf in tree_items(flat):
            if not isinstance(leaf, specs_lib.Sharded):
                assert path == ("length",)
                continue
            ax = flat_axes
            for k in path:
                ax = ax[k]
            want = jcommon.resolve_spec(ax[:leaf.value.ndim], tuple(leaf.shape), stub)
            assert tuple(leaf.sharding.spec) == tuple(want), path
            n += 1
        assert n == (3 if family == "transformer" else 7)


def _store_pair(ef_fmt=None):
    """The reference's case (tests/test_launch.py): a 1-layer conformer,
    4 clients in 2 shards, with rows 1 and 3 set from a seed."""
    from repro.core.omc import OMCConfig as JOMC
    from repro.models import conformer as jcf
    from repro.scale import PopulationStore as JStore, ShardLayout as JLayout
    from repro_torch.core.omc import OMCConfig
    from repro_torch.models import conformer as cf
    from repro_torch.scale import PopulationStore, ShardLayout

    jcfg = jcf.ConformerConfig(n_layers=1, d_model=16, n_heads=2, d_ff=32, n_classes=8, d_in=4)
    cfg = cf.ConformerConfig(n_layers=1, d_model=16, n_heads=2, d_ff=32, n_classes=8, d_in=4)
    jstore = JStore(JLayout(4, 2))
    jstore.init_ef(jcf.init(jax.random.PRNGKey(0), jcfg), jcf.param_specs(jcfg),
                   JOMC.parse("S1E3M7"), ef_fmt=ef_fmt)
    store = PopulationStore(ShardLayout(4, 2), device="cpu")
    store.init_ef(cf.init(prng.PRNGKey(0), cfg, "meta"), cf.param_specs(cfg),
                  OMCConfig.parse("S1E3M7"), ef_fmt=ef_fmt)
    assert store.ef_names == jstore.ef_names
    rng = np.random.default_rng(7)
    rows = {k: rng.standard_normal((2,) + v.shape, dtype=np.float32) * 0.01
            for k, v in store._ef.items()}
    jstore.scatter_ef([1, 3], {k: jax.numpy.asarray(v) for k, v in rows.items()})
    store.scatter_ef([1, 3], {k: torch.from_numpy(v) for k, v in rows.items()})
    return jstore, store


def test_device_ef_f32_rows_match_reference_bit_for_bit():
    jstore, store = _store_pair()
    rows = store.device_ef(mesh_lib.make_population_mesh(num_shards=2, device="cpu"))
    jrows = jstore.device_ef(jmesh_lib.make_population_mesh(num_shards=2))
    assert rows and set(rows) == set(jrows)
    for k, v in rows.items():
        assert isinstance(v, specs_lib.Sharded) and v.sharding.spec == P()
        assert v.shape[0] == 4 and v.value.dtype == torch.float32
        assert np.array_equal(v.value.numpy().view(np.uint32),
                              np.asarray(jrows[k]).view(np.uint32)), k
        assert np.any(v.value.numpy() != 0)


def test_device_ef_packed_rows_are_gather_ef_bits():
    _, store = _store_pair("S1E3M7")
    mesh = mesh_lib.make_population_mesh(num_shards=4, device="cpu")
    rows = store.device_ef(mesh, client_ids=[3, 0, 1])
    want = store.gather_ef([3, 0, 1])
    for k, v in rows.items():
        assert v.shape[0] == 3
        assert torch.equal(v.value.view(torch.int32), want[k].view(torch.int32)), k
    assert any(bool((v.value != 0).any()) for v in rows.values())
