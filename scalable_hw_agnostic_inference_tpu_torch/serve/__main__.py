"""Pod entrypoint: ``python -m scalable_hw_agnostic_inference_tpu_torch.serve <unit>``.

Port of ``scalable_hw_agnostic_inference_tpu/serve/__main__.py``: the unit
name comes from argv or the ``MODEL`` env var, everything else from the
env contract (``utils.env.ServeConfig``). ``DEVICE`` defaults to ``cuda``;
``DEVICE=cpu`` runs the plain paths on the CPU.
"""

import logging
import sys

from ..utils.env import ServeConfig, env_str
from .app import serve_forever
from .units import UNITS


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
    serve_forever(cfg, UNITS[name](cfg))


if __name__ == "__main__":
    main()
