"""The port's fault tolerance (``repro_torch.train.fault_tolerance``) and
training sharding rules (``repro_torch.sharding``), twins of
``test_substrate.py::TestFaultTolerance`` and of ``test_sharding.py``'s
spec tests, with every spec equal to the reference's ``PartitionSpec``
entries for every architecture: on the one-device host mesh and on a
(16, 16) mesh of placeholder ids, where the divisibility fallback
decides. ``make_constrain`` is the identity on one device and on a
(data, model) mesh for the dense family, and refuses a model axis over
two devices for a model with experts, and a pod axis over two."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget
from repro.models import get_model as jmodel
from repro.sharding import rules as jrules
from repro_torch import tree as T
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import get_model
from repro_torch.sharding import (DIE_AXIS, DieMesh, Mesh, NamedSharding,
                                  make_host_mesh, make_production_mesh)
from repro_torch.sharding.mesh import device_grid
from repro_torch.sharding.rules import (_axis_size, default_rules,
                                        make_constrain, mesh_shards,
                                        spec_for, strategy_rules,
                                        tree_shardings)
from repro_torch.train import fault_tolerance as ft

CPU = torch.device("cpu")


class TestFaultTolerance:
    def test_heartbeat(self):
        t = [0.0]
        hb = ft.HeartbeatMonitor(timeout_s=10, clock=lambda: t[0])
        hb.beat("h0"); hb.beat("h1")
        t[0] = 5.0
        hb.beat("h1")
        t[0] = 12.0
        assert hb.dead_hosts() == ["h0"]
        assert hb.alive_hosts() == ["h1"]

    def test_straggler_flags_slow_host(self):
        sm = ft.StragglerMonitor(threshold=1.5, window=16)
        for step in range(20):
            sm.record("fast0", step, 1.0)
            sm.record("fast1", step, 1.05)
            sm.record("slow", step, 2.2)
        assert sm.chronic(min_flags=3) == ["slow"]

    def test_elastic_mesh_preserves_tp(self):
        devs = list(range(64))  # stand-in device objects
        mesh = ft.best_elastic_mesh(devs, model_parallel=16)
        assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {
            "data": 4, "model": 16}
        mesh2 = ft.best_elastic_mesh(devs[:50], model_parallel=16)
        rep = ft.remesh_report(64, mesh2)
        assert rep["dp_degree"] == 3 and rep["idle_devices"] == 16
        assert rep["new_shape"] == {"data": 3, "model": 16}

    def test_elastic_mesh_too_small_raises(self):
        with pytest.raises(RuntimeError):
            ft.best_elastic_mesh(list(range(8)), model_parallel=16)

    def test_recovery_plan(self):
        t = [0.0]
        hb = ft.HeartbeatMonitor(timeout_s=10, clock=lambda: t[0])
        sm = ft.StragglerMonitor()
        hosts = {f"h{i}": list(range(i * 8, (i + 1) * 8)) for i in range(4)}
        for h in hosts:
            hb.beat(h)
        pol = ft.RecoveryPolicy(hb, sm, model_parallel=8)
        assert pol.plan(hosts)["action"] == "none"
        t[0] = 20.0
        for h in list(hosts)[1:]:
            hb.beat(h)
        plan = pol.plan(hosts)
        assert plan["action"] == "remesh"
        assert plan["dead_hosts"] == ["h0"]
        assert plan["report"]["new_devices"] == 24


def test_reshard_state_lays_leaves_on_the_mesh_device():
    mesh = make_host_mesh(CPU)
    state = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.zeros(3)}
    sh = {k: NamedSharding(mesh, (None,) * v.dim()) for k, v in state.items()}
    out = ft.reshard_state(state, sh)
    assert all(torch.equal(out[k], state[k]) for k in state)
    assert all(v.device == CPU for v in out.values())


@pytest.fixture(scope="module")
def meshes():
    """(port, reference) host meshes and (16, 16) placeholder meshes."""
    ids = np.arange(256).reshape(16, 16)
    return {"host": (make_host_mesh(CPU), JMesh(
                np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))),
            "pod": (Mesh(device_grid(list(range(256)), (16, 16)),
                         ("data", "model")), JMesh(ids, ("data", "model")))}


class TestSpecFor:
    def test_basic_mapping(self, meshes):
        mesh = meshes["host"][0]
        spec = spec_for(mesh, default_rules(mesh), ("batch", None, "mlp"),
                        (8, 4, 128))
        assert spec == tuple(P(("data",), None, "model"))

    def test_divisibility_fallback(self, meshes):
        mesh = meshes["host"][0]
        assert _axis_size(mesh, "model") == 1
        assert spec_for(mesh, default_rules(mesh), ("heads",), (10,)) == (
            "model",)
        pod = meshes["pod"][0]
        assert spec_for(pod, default_rules(pod), ("heads",), (10,)) == (
            None,)

    def test_none_logical_axis(self, meshes):
        mesh = meshes["host"][0]
        assert spec_for(mesh, default_rules(mesh), (None, None),
                        (2, 2)) == (None, None)


def _leaves_of_axes(tree):
    if isinstance(tree, tuple):
        return [tree]
    return [x for k in sorted(tree) for x in _leaves_of_axes(tree[k])]


@pytest.mark.parametrize("arch", ARCHS)
def test_all_param_shardings_construct(meshes, arch):
    """Every leaf's spec equals the reference's, on both meshes and under
    each rules strategy; the leaves and their order are the
    reference's."""
    api, japi = get_model(get_config(arch)), jmodel(jget(arch))
    axes, shapes = api.param_axes(), api.param_shapes()
    is_ax = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        isinstance(e, (str, type(None))) for e in x)
    j_axes = jax.tree.leaves(japi.param_axes(), is_leaf=is_ax)
    assert _leaves_of_axes(axes) == j_axes
    for name, (mesh, jmesh) in meshes.items():
        for strategy in ("baseline", "serve_tp_only", "serve_moe_2d"):
            sh = tree_shardings(mesh, strategy_rules(mesh, strategy), axes,
                                shapes)
            jsh = jrules.tree_shardings(
                jmesh, jrules.strategy_rules(jmesh, strategy),
                japi.param_axes(), japi.param_shapes())
            got = [s.spec for s in T.leaves(sh)]
            want = [tuple(s.spec) for s in jax.tree.leaves(jsh)]
            assert got == want, (name, strategy)
            assert all(isinstance(s, NamedSharding) for s in T.leaves(sh))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_construct(meshes, arch):
    api = get_model(get_config(arch).reduced())
    japi = jmodel(jget(arch).reduced())
    cache = api.init_cache(2, 16, CPU)
    jcache = jax.eval_shape(lambda: japi.init_cache(2, 16))
    flat, tdef = T.flatten_with_def(cache)
    flat_ax = tdef.flatten_up_to(api.cache_axes())
    jflat, jdef = jax.tree.flatten(jcache)
    jflat_ax = jdef.flatten_up_to(japi.cache_axes())
    assert [tuple(x.shape) for _, x in flat] == [s.shape for s in jflat]
    for name, (mesh, jmesh) in meshes.items():
        rules, jr = default_rules(mesh), jrules.default_rules(jmesh)
        for (_, x), ax, js, jax_ax in zip(flat, flat_ax, jflat, jflat_ax):
            assert spec_for(mesh, rules, ax, x.shape) == tuple(
                jrules.spec_for(jmesh, jr, jax_ax, js.shape)), name


def test_constrain_is_identity_on_host_mesh(meshes):
    mesh = meshes["host"][0]
    constrain = make_constrain(mesh, default_rules(mesh))
    x = torch.ones((4, 8))
    assert constrain(x, ("batch", "mlp")) is x


@pytest.mark.parametrize("refused", ["moe_over_model", "pod"])
def test_constrain_refuses_a_mesh_over_two_devices(refused):
    """Two devices on the model axis take the dense family, and still
    refuse a model with experts (its shards: expert parallelism is a
    later slice); two devices on a pod axis are refused for any
    model."""
    dense = get_model(get_config("qwen2.5-3b").reduced())
    if refused == "pod":
        mesh = Mesh(device_grid([CPU, CPU], (2, 1, 1)),
                    ("pod", "data", "model"))
        for api in (dense, get_model(get_config("dbrx-132b").reduced())):
            with pytest.raises(NotImplementedError, match="pod axis"):
                make_constrain(mesh, default_rules(mesh), api.cfg)
        return
    mesh = Mesh(device_grid([CPU, CPU], (1, 2)), ("data", "model"))
    x = torch.ones(2)
    assert make_constrain(mesh, default_rules(mesh), dense.cfg)(x, None) \
        is x
    moe = get_model(get_config("dbrx-132b").reduced())
    with pytest.raises(NotImplementedError,
                       match="expert.*later slice"):
        mesh_shards(mesh, default_rules(mesh), moe)


def test_training_meshes():
    host = make_host_mesh(CPU)
    assert host.shape == {"data": 1, "model": 1}
    assert host.devices.flat[0] == CPU
    one = make_production_mesh(shape=(1, 1), device=CPU)
    assert one.shape == {"data": 1, "model": 1}
    with pytest.raises(RuntimeError, match="need 256 devices"):
        make_production_mesh(device=CPU)
    with pytest.raises(RuntimeError, match="need 512 devices"):
        make_production_mesh(multi_pod=True, device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_host_mesh()


def test_die_mesh_device_mesh_folds_onto_the_device():
    m = DieMesh(n_dies=4, capacity=8)
    dm = m.device_mesh(CPU)
    assert dm.axis_names == (DIE_AXIS,) and dm.size == 1
    sh = m.sharding_for(3, 1, CPU)
    assert sh.spec == (None, DIE_AXIS, None) and sh.device == CPU
