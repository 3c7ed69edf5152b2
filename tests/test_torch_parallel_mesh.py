"""The port's placement rules (``avatar_tpu_torch/parallel/mesh.py``,
``parallel/pipeline.py``, ``parallel/distributed.py``) against the JAX
package's ``NamedSharding`` specs, leaf by leaf, with no processes: the
rules are functions of shapes and of the mesh's axis sizes. A linear
``weight`` is [out, in] in the port and its ``kernel`` [in, out] in JAX,
so a port dim is compared with the JAX dim that holds the same axis."""

import types

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

from avatar_tpu.models import dit as jdit
from avatar_tpu.parallel import distributed as jdist
from avatar_tpu.parallel import mesh as jmesh
from avatar_tpu.parallel import pipeline as jpipe
from avatar_tpu_torch.models import dit as tdit
from avatar_tpu_torch.parallel import distributed as tdist
from avatar_tpu_torch.parallel import mesh as tmesh
from avatar_tpu_torch.parallel import pipeline as tpipe
from avatar_tpu_torch.utils.weight_import import dit_params_from_numpy
from torch_parity import dit_numpy_params

CFG_KW = dict(num_attention_heads=4, attention_head_dim=16, in_channels=16, out_channels=16,
              num_layers=2, cross_attention_dim=64, caption_channels=96)


@pytest.fixture(scope="module")
def trees():
    tree = dit_numpy_params(jdit.DiTConfig(**CFG_KW))
    return tree, dit_params_from_numpy(tree, tdit.DiTConfig(**CFG_KW), device="cpu")


def _shape_mesh(**axes):
    """The port's rules read only the mesh's axis sizes."""
    return types.SimpleNamespace(shape=dict(axes))


def _jax_mesh(**axes):
    n = int(np.prod(list(axes.values())))
    return JMesh(np.asarray(jax.devices()[:n]).reshape(*axes.values()), tuple(axes))


def _port_key(key):
    return "weight" if key == "kernel" else key


def _pairs(jtree, ttree, path=()):
    """(path, JAX leaf, port leaf) matched by key ("kernel" -> "weight")."""
    if isinstance(jtree, dict):
        for k, v in jtree.items():
            yield from _pairs(v, ttree[_port_key(k)], path + (_port_key(k),))
    elif isinstance(jtree, (list, tuple)):
        for i, (a, b) in enumerate(zip(jtree, ttree)):
            yield from _pairs(a, b, path + (i,))
    else:
        yield path, jtree, ttree


def _as_jax_spec(path, port_spec, port_leaf):
    """A port spec (an int dim over 'fsdp', or axis names per dim) as the
    JAX spec of the same leaf: axis names per JAX dim."""
    shape = tuple(port_leaf.shape)
    if port_spec is None:
        port_spec = (None,) * len(shape)
    elif isinstance(port_spec, int):
        port_spec = tuple("fsdp" if d == port_spec else None for d in range(len(shape)))
    order = tmesh.jax_dim_order(path, shape)
    return tuple(port_spec[d] for d in order)


def _jax_spec(sharding, ndim):
    return tuple(sharding.spec) + (None,) * (ndim - len(sharding.spec))


def _compare(jspecs, tspecs, jtree, ttree):
    jflat = dict((p, s) for p, s, _ in _pairs(jspecs, ttree))
    n = 0
    for path, jleaf, tleaf in _pairs(jtree, ttree):
        tspec = _lookup(tspecs, path)
        assert _as_jax_spec(path, tspec, tleaf) == _jax_spec(jflat[path], np.ndim(jleaf)), path
        n += 1
    return n


def _lookup(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("mode", ["dp", "zero2", "fsdp"])
@pytest.mark.parametrize("min_size", [2**16, 64])
def test_param_sharding_matches_jax(trees, mode, min_size):
    jtree, ttree = trees
    jspecs = jmesh.param_sharding(_jax_mesh(data=4, fsdp=2, tp=1), jtree, mode=mode,
                                  min_size=min_size)
    tspecs = tmesh.param_sharding(_shape_mesh(data=4, fsdp=2, tp=1), ttree, mode=mode,
                                  min_size=min_size)
    sharded = [s for s in jax.tree.leaves(tspecs) if s is not None]
    assert _compare(jspecs, tspecs, jtree, ttree) > 20
    assert bool(sharded) == (mode == "fsdp" and min_size == 64)


@pytest.mark.parametrize("mode", ["dp", "zero2", "fsdp"])
def test_opt_state_sharding_matches_jax(trees, mode):
    """Moments shaped like the params get the params' rule: ZeRO-2 shards
    them even where the params stay replicated."""
    jtree, ttree = trees
    jspecs = jmesh.opt_state_sharding(_jax_mesh(data=4, fsdp=2, tp=1), jtree, None,
                                      mode=mode, min_size=64)
    tspecs = tmesh.opt_state_sharding(_shape_mesh(data=4, fsdp=2, tp=1), ttree, mode=mode,
                                      min_size=64)
    _compare(jspecs, tspecs, jtree, ttree)


@pytest.mark.parametrize("fsdp,tp,mode", [(1, 2, "dp"), (2, 2, "fsdp"), (1, 4, "zero2"),
                                          (2, 1, "fsdp")])
def test_dit_param_sharding_matches_jax(trees, fsdp, tp, mode):
    jtree, ttree = trees
    data = 8 // (fsdp * tp)
    jspecs = jmesh.dit_param_sharding(_jax_mesh(data=data, fsdp=fsdp, tp=tp), jtree,
                                      mode=mode, min_size=64)
    tspecs = tmesh.dit_param_sharding(_shape_mesh(data=data, fsdp=fsdp, tp=tp), ttree,
                                      mode=mode, min_size=64)
    _compare(jspecs, tspecs, jtree, ttree)


@pytest.mark.parametrize("pp", [2, 4])
def test_pp_param_sharding_matches_jax(trees, pp):
    jtree, ttree = trees
    jstacked = dict(jtree, blocks=jpipe.stack_block_params(jtree["blocks"]))
    tstacked = dict(ttree, blocks=tpipe.stack_block_params(ttree["blocks"]))
    jspecs = jpipe.pp_param_sharding(_jax_mesh(data=8 // pp, pp=pp), jstacked)
    tspecs = tpipe.pp_param_sharding(_shape_mesh(data=8 // pp, pp=pp), tstacked)
    assert _compare(jspecs, tspecs, jstacked, tstacked) > 20
    with pytest.raises(ValueError):
        tpipe.pp_param_sharding(_shape_mesh(data=8), tstacked)


def test_stack_unstack_roundtrip(trees):
    _, ttree = trees
    back = tpipe.unstack_block_params(tpipe.stack_block_params(ttree["blocks"]))
    for a, b in zip(ttree["blocks"], back):
        for (_, x, y) in _pairs(a, b):
            assert (x == y).all()
    # the DiT module's import of them stays
    assert tdit.stack_block_params is tpipe.stack_block_params


@pytest.mark.parametrize("n,count", [(8, 1), (8, 2), (8, 4), (12, 4), (6, 4)])
def test_process_local_slice_matches_jax(monkeypatch, n, count):
    for p in range(count):
        monkeypatch.setattr(jdist.jax, "process_index", lambda p=p: p)
        monkeypatch.setattr(jdist.jax, "process_count", lambda: count)
        monkeypatch.setattr(tdist, "process_index", lambda p=p: p)
        monkeypatch.setattr(tdist, "process_count", lambda: count)
        if n % count:
            with pytest.raises(ValueError):
                jdist.process_local_slice(n)
            with pytest.raises(ValueError):
                tdist.process_local_slice(n)
        else:
            assert tdist.process_local_slice(n) == jdist.process_local_slice(n)


def test_one_process_mesh_and_helpers():
    """Without a process group: a mesh of one rank, every group trivial,
    make_mesh's remainder and assertion, the no-op initialize, gather and
    barrier."""
    import torch

    mesh = tmesh.make_mesh()
    assert mesh.shape == {"data": 1, "fsdp": 1, "tp": 1}
    assert mesh.group(("data", "fsdp")).trivial and mesh.group("tp").size == 1
    with pytest.raises(AssertionError):
        tmesh.make_mesh(data=2)
    with pytest.raises(ValueError):
        tmesh.Mesh(np.arange(2), ("data",))
    assert not tdist.initialize()
    assert tdist.is_main_process() and tdist.process_count() == 1
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(tdist.gather_to_host({"a": [x]}, {"a": [1]}, mesh)["a"][0], x)
    assert torch.equal(tdist.global_batch_from_local(x.numpy(), 2, device="cpu"), x)
    with pytest.raises(ValueError):
        tdist.global_batch_from_local(x.numpy(), 4)
    tdist.sync_processes()
