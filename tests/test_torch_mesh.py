"""The port's ``core/mesh.py``, the multi-host env contract
(``core/device.py``'s ``distributed_env``) and the unit placement built
on them (``serve/units/common.py``'s ``unit_layout``/``unit_ranks``), held
against the reference, with no process spawned:

- ``MeshSpec.parse``, ``resolve_sizes`` and ``axis_names``,
  ``parse_submesh`` and ``submesh``, case for case against the reference's
  ``core/mesh.py`` over a list of specs with its error cases (the same
  exception type, the same message);
- the env contract against ``maybe_distributed_init``'s rules, its
  ``jax.distributed.initialize`` stood in by a recorder;
- ``rank_layout``: the tp size, each local rank's device and global rank
  (one host, the multi-host manifests' ``tp=16`` and ``tp=32``), and the
  refusals (an axis other than tp, a host count that does not divide tp,
  more NCCL ranks than cards, ``-1`` over gloo, a process id out of
  range);
- the units: ``llama`` and ``t5`` over ranks without a group refused
  (naming ``serve_multihost``), the one-device units refused naming
  ROADMAP A7.3c, ``start_ranks`` refusing before any process starts, the ``vllm`` unit's ``tensor_parallel_size`` past the host's
  cards refused with the reference's message, the entry point's choice.
"""

import multiprocessing
import types

import jax
import pytest
import torch

from scalable_hw_agnostic_inference_tpu.core import device as jdevice
from scalable_hw_agnostic_inference_tpu.core import mesh as jmesh
from scalable_hw_agnostic_inference_tpu_torch.core import mesh as pmesh
from scalable_hw_agnostic_inference_tpu_torch.core.device import (
    HostPlace,
    distributed_env,
)
from scalable_hw_agnostic_inference_tpu_torch.serve.__main__ import (
    wants_ranks,
)
from scalable_hw_agnostic_inference_tpu_torch.serve.multihost import (
    start_ranks,
)
from scalable_hw_agnostic_inference_tpu_torch.serve.units import UNITS
from scalable_hw_agnostic_inference_tpu_torch.serve.units import vllm
from scalable_hw_agnostic_inference_tpu_torch.serve.units.common import (
    unit_layout,
    unit_ranks,
)
from scalable_hw_agnostic_inference_tpu_torch.utils.env import ServeConfig

SPECS = ["", "tp=4", "dp=2,tp=4", "tp=4,dp=2", " tp = 4 ", "tp=4,",
         "tp=-1", "dp=-1,tp=2", "pp=2,dp=1,ep=1,sp=1,tp=2", "tp=0",
         "tp=x", "tp=04", "foo=2", "tp=2,tp=2", "dp=-1,tp=-1", "tp=-2",
         "tp"]
DEVICE_COUNTS = [1, 4, 6, 8]


def _outcome(fn, *args):
    """``("ok", value)`` or ``(exception type, message)``."""
    try:
        return "ok", fn(*args)
    except Exception as e:
        return type(e), str(e)


@pytest.mark.parametrize("spec", SPECS)
def test_mesh_spec_equals_the_reference(spec):
    want, got = (_outcome(m.MeshSpec.parse, spec) for m in (jmesh, pmesh))
    assert got[0] == want[0] and (got[0] != "ok" or got[1].axes ==
                                  want[1].axes), (got, want)
    if want[0] != "ok":
        assert got == want
        return
    assert got[1].axis_names == want[1].axis_names
    for n in DEVICE_COUNTS:
        assert _outcome(got[1].resolve_sizes, n) == \
            _outcome(want[1].resolve_sizes, n), (spec, n)


@pytest.mark.parametrize("spec", ["", "0:4", "2:8", " 1:2 ", "4:4", "5:3",
                                  "a:b", "0-4", "3:"])
def test_parse_submesh_equals_the_reference(spec):
    assert _outcome(pmesh.parse_submesh, spec) == \
        _outcome(jmesh.parse_submesh, spec)


@pytest.mark.parametrize("start,count", [(0, 1), (0, 8), (4, 4), (6, 4),
                                         (-1, 2), (8, 1), (7, 1)])
def test_submesh_equals_the_reference(start, count):
    devices = list(range(8))
    assert _outcome(pmesh.submesh, start, count, devices) == \
        _outcome(jmesh.submesh, start, count, devices)


ENVS = {
    "unset": {},
    "empty": {"SHAI_COORDINATOR": ""},
    "mh": {"SHAI_COORDINATOR": "llama-mh-0.llama-mh:8476",
           "SHAI_NUM_PROCESSES": "4", "SHAI_PROCESS_ID": "3"},
    "no_count": {"SHAI_COORDINATOR": "h:1", "SHAI_PROCESS_ID": "0"},
    "no_id": {"SHAI_COORDINATOR": "h:1", "SHAI_NUM_PROCESSES": "2"},
    "bad_count": {"SHAI_COORDINATOR": "h:1", "SHAI_NUM_PROCESSES": "two",
                  "SHAI_PROCESS_ID": "0"},
}


@pytest.mark.parametrize("name", sorted(ENVS))
def test_env_contract_follows_maybe_distributed_init(name, monkeypatch):
    joined = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: joined.append(kw))
    env = ENVS[name]
    want = _outcome(jdevice.maybe_distributed_init, env)
    got = _outcome(distributed_env, env)
    if want[0] != "ok":
        assert got[0] is want[0]
        return
    if not want[1]:
        assert got == ("ok", None) and not joined
        return
    [kw] = joined
    assert got == ("ok", HostPlace(kw["coordinator_address"],
                                   kw["num_processes"], kw["process_id"]))


CPU, CUDA0 = torch.device("cpu"), torch.device("cuda", 0)


@pytest.mark.parametrize("spec,device,backend,place,cards,want", [
    ("", CPU, "gloo", None, 0, (1, 1, 0, 1, (CPU,), [0])),
    ("tp=2", CPU, "gloo", None, 0, (2, 1, 0, 2, (CPU,) * 2, [0, 1])),
    ("tp=2", CUDA0, "gloo", None, 1, (2, 1, 0, 2, (CUDA0,) * 2, [0, 1])),
    ("tp=4", CUDA0, "nccl", None, 4,
     (4, 1, 0, 4, tuple(torch.device("cuda", i) for i in range(4)),
      [0, 1, 2, 3])),
    # llama-mh-tpu-deploy.yaml: tp=16 over 4 processes of 4 cards
    ("tp=16", CUDA0, "nccl", HostPlace("c:1", 4, 2), 4,
     (16, 4, 2, 4, tuple(torch.device("cuda", i) for i in range(4)),
      [8, 9, 10, 11])),
    # dsr70b-mh-tpu-deploy.yaml: tp=32 over 8
    ("tp=32", CUDA0, "nccl", HostPlace("c:1", 8, 7), 4,
     (32, 8, 7, 4, tuple(torch.device("cuda", i) for i in range(4)),
      [28, 29, 30, 31])),
    ("tp=-1", CUDA0, "nccl", HostPlace("c:1", 2, 1), 2,
     (4, 2, 1, 2, (CUDA0, torch.device("cuda", 1)), [2, 3])),
    ("tp=2", CPU, "gloo", HostPlace("c:1", 2, 1), 0,
     (2, 2, 1, 1, (CPU,), [1])),
])
def test_rank_layout(spec, device, backend, place, cards, want):
    lay = pmesh.rank_layout(spec, device, backend, place, n_cards=cards)
    assert (lay.tp, lay.hosts, lay.host, lay.local, lay.devices,
            [lay.rank(i) for i in range(lay.local)]) == want
    assert lay.ranked == (lay.tp > 1 or place is not None)


@pytest.mark.parametrize("spec,device,backend,place,cards,match", [
    ("dp=2,tp=4", CPU, "gloo", None, 0, r"tensor parallelism only.*'dp'"),
    ("dp=2,tp=1", CUDA0, "nccl", None, 1, r"axes \{'dp': 2\}"),
    ("dp=-1,tp=2", CPU, "gloo", None, 0, "tensor parallelism only"),
    ("tp=2", CPU, "gloo", HostPlace("c:1", 3, 0), 0,
     "SHAI_NUM_PROCESSES=3 does not divide tp=2"),
    ("tp=2", CUDA0, "nccl", None, 1, "2 NCCL ranks on this host.*1 card"),
    ("tp=16", CUDA0, "nccl", HostPlace("c:1", 2, 0), 4,
     "8 NCCL ranks on this host.*4 card"),
    ("tp=-1", CPU, "gloo", None, 0, "name tp's size"),
    ("tp=2", CPU, "nccl", None, 0, "NCCL group runs on the card"),
    ("tp=2", CPU, "gloo", HostPlace("c:1", 2, 2), 0,
     "SHAI_PROCESS_ID=2 outside SHAI_NUM_PROCESSES=2"),
])
def test_rank_layout_refusals(spec, device, backend, place, cards, match):
    with pytest.raises(ValueError, match=match):
        pmesh.rank_layout(spec, device, backend, place, n_cards=cards)


def _cfg(**kw):
    return ServeConfig(**{"app": "u", "device": "cpu", "model_id": "tiny",
                          **kw})


def test_units_over_ranks_and_their_refusals(monkeypatch):
    for k in ("SHAI_COORDINATOR", "SHAI_NUM_PROCESSES", "SHAI_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    # the llama unit at tp=2: laid out, and refused without its group
    dev, lay = unit_layout(_cfg(mesh_spec="tp=2"), multihost=True)
    assert dev == CPU and lay.tp == 2 and lay.ranked
    with pytest.raises(ValueError, match="serve_multihost"):
        UNITS["llama"](_cfg(mesh_spec="tp=2")).load()
    # one device, as before: no group
    assert unit_ranks(_cfg(mesh_spec="tp=1", submesh="0:1"), True) == \
        (CPU, None)
    with pytest.raises(ValueError, match="tensor parallelism only"):
        UNITS["mistral"](_cfg(mesh_spec="dp=2,tp=2")).load()
    with pytest.raises(ValueError, match="SUBMESH names 4 devices.*A7.3c"):
        UNITS["deepseek"](_cfg(submesh="0:4")).load()
    with pytest.raises(ValueError, match="MESH_SPEC names 2 devices.*"
                       "A7.3c"):
        UNITS["bert"](_cfg(mesh_spec="tp=2")).load()
    monkeypatch.setenv("SHAI_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("SHAI_NUM_PROCESSES", "1")
    monkeypatch.setenv("SHAI_PROCESS_ID", "0")
    with pytest.raises(ValueError, match="SHAI_COORDINATOR.*A7.3c"):
        UNITS["bert"](_cfg()).load()
    # a coordinator alone asks for a group (of one)
    assert unit_layout(_cfg(), multihost=True)[1].ranked
    assert wants_ranks(_cfg())


def test_start_ranks_refuses_before_any_process(monkeypatch):
    monkeypatch.delenv("SHAI_COORDINATOR", raising=False)
    before = multiprocessing.active_children()
    with pytest.raises(ValueError, match="A7.3c"):
        start_ranks(_cfg(mesh_spec="tp=2"), UNITS["bert"](_cfg()))
    plain = types.SimpleNamespace(cfg=None)
    with pytest.raises(ValueError, match="does not declare "
                       "supports_multihost"):
        start_ranks(_cfg(), plain)
    monkeypatch.setenv("SHAI_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("SHAI_NUM_PROCESSES", "3")
    monkeypatch.setenv("SHAI_PROCESS_ID", "0")
    with pytest.raises(ValueError, match="SHAI_NUM_PROCESSES=3"):
        start_ranks(_cfg(mesh_spec="tp=2"), UNITS["llama"](_cfg()))
    assert multiprocessing.active_children() == before
    assert UNITS["llama"].supports_multihost
    assert UNITS["llama"].mirror_methods == ("generate_text",)
    assert not UNITS["vllm"].supports_multihost


def test_entry_point_asks_for_ranks(monkeypatch):
    monkeypatch.delenv("SHAI_COORDINATOR", raising=False)
    assert [wants_ranks(_cfg(mesh_spec=s)) for s in
            ("", "tp=1", "tp=2", "tp=-1", "dp=1,tp=4")] == \
        [False, False, True, True, True]


def test_vllm_tp_past_the_cards_is_refused(tmp_path, monkeypatch):
    """The reference's refusal (``serve/units/vllm.py:212-217``), before
    any weight or process: the card stood in for a one-card host."""
    path = tmp_path / "cm.yaml"
    path.write_text('{"tensor_parallel_size": 2}')
    monkeypatch.setattr(vllm, "unit_device", lambda cfg: CUDA0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    before = multiprocessing.active_children()
    with pytest.raises(ValueError, match="tensor_parallel_size=2 exceeds "
                       "the 1 local devices of this unit"):
        UNITS["vllm"](_cfg(app="vllm", vllm_config=str(path))).load()
    assert multiprocessing.active_children() == before
