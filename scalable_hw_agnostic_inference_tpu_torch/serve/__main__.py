"""Pod entrypoint: ``python -m scalable_hw_agnostic_inference_tpu_torch.serve <unit>``.

Port of ``scalable_hw_agnostic_inference_tpu/serve/__main__.py``: the unit
name comes from argv or the ``MODEL`` env var, everything else from the
env contract (``utils.env.ServeConfig``). ``DEVICE`` defaults to ``cuda``;
``DEVICE=cpu`` runs the plain paths on the CPU. Where the env asks for
several ranks (``MESH_SPEC`` with a tp above 1, or ``SHAI_COORDINATOR``),
the unit is served over them (``serve.multihost.serve_multihost``: the
leader serves HTTP, the other ranks mirror it); otherwise on one device
(``serve_forever``).
"""

import logging
import sys

from ..core.device import distributed_env
from ..core.mesh import MeshSpec, cards, parse_submesh
from ..utils.env import ServeConfig, env_str
from .app import serve_forever
from .units import UNITS


def wants_ranks(cfg: ServeConfig, service=None) -> bool:
    """The env asks for several ranks: a coordinator, or a tp other than 1
    in ``MESH_SPEC``; for a unit whose ranks ``SUBMESH`` lays out
    (``flux``), a ``SUBMESH`` naming several devices, or, unset, a host
    of several cards (the transformer spans every one)."""
    if distributed_env() is not None:
        return True
    if getattr(service, "ranks_over", None) == "SUBMESH":
        sub = parse_submesh(cfg.submesh)
        if sub is not None:
            return sub[1] != 1
        return (str(cfg.device or "cuda").startswith("cuda")
                and len(cards()) > 1)
    tp = dict(MeshSpec.parse(cfg.mesh_spec).axes).get("tp", 1)
    return tp != 1


def main() -> None:
    logging.basicConfig(
        level=env_str("LOG_LEVEL", "INFO"),
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    name = sys.argv[1] if len(sys.argv) > 1 else env_str("MODEL", "")
    if name not in UNITS:
        print(f"usage: python -m scalable_hw_agnostic_inference_tpu_torch.serve"
              f" <unit>\navailable: {', '.join(UNITS)}", file=sys.stderr)
        raise SystemExit(2)
    cfg = ServeConfig.from_env()
    service = UNITS[name](cfg)
    if wants_ranks(cfg, service):
        from .multihost import serve_multihost

        serve_multihost(cfg, service)
    else:
        serve_forever(cfg, service)


if __name__ == "__main__":
    main()
