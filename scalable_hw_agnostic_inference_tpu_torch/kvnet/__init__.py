"""kvnet: network KV transport for disaggregated prefill/decode serving.

Port of ``scalable_hw_agnostic_inference_tpu/kvnet/`` (``resolve_role``,
``frames``, ``client``, ``migrate``, ``directory``). The host KV tier
(``kvtier/``) stores blocks content-addressed by the same chain hashes as
the device prefix cache; this package adds the wire between pods, so a
*prefill* pod's warm KV feeds a *decode* pod's host tier, a draining pod
ships its in-flight requests to a peer, and a prefix warm on one pod is
warm on every pod of the fabric:

- :mod:`.frames` -- the length-prefixed binary frame codec, byte-exact
  and byte-compatible with a JAX pod's;
- :mod:`.client` -- the puller: stdlib HTTP, connect-only retries, a
  per-peer circuit breaker, the peer allowlist and the ``kvnet.fetch``
  fault site; fetched blocks land in ``HostKVTier.store_batch`` and
  restore through the cache's ordinary ``restore_prefix``;
- :mod:`.migrate` -- live migration: the ``KVMG`` envelope (byte-compatible
  with a JAX pod's), the resume inbox, the ship and the restore;
- :mod:`.directory` -- the fleet KV fabric: the content-addressed holder
  directory and the engine's peer-probe admission rung;
- the pod-side routes (``GET /kv/blocks``, ``GET /kv/digests``,
  ``POST /kv/pull``, ``POST /kv/protect``, ``POST /kv/migrate``) live in
  ``serve/app.py``.

Failure contract: every transport failure degrades to local recompute,
never to a failed request; the degrade signal is
``shai_kvnet_fallbacks_total``.

Roles (``SHAI_ROLE`` / ``EngineConfig.role``): a ``prefill`` pod finishes
the prompt, banks its full-block run in the host tier and returns a
``{kv_ready, digest, hashes_len, peer_url}`` handoff instead of decoding;
a ``decode`` pod takes the handoff as ``kv_peer``, pulls the run and
generates; ``both`` (the default) is the monolithic pod.
"""

from __future__ import annotations

import logging

from ..utils.env import env_str

log = logging.getLogger(__name__)

#: the closed role set: "prefill" warms KV and hands off, "decode" pulls
#: and generates, "both" is the monolithic default
ROLES = ("prefill", "decode", "both")


def resolve_role(default: str = "both") -> str:
    """The pod's serving role: ``SHAI_ROLE`` wins over the engine config's
    ``role`` (``default``). Lenient: an unrecognized value warns and keeps
    the config role (a typo must not boot a prefill tier as a monolith)."""
    v = (env_str("SHAI_ROLE", "") or "").strip().lower()
    if not v:
        return default if default in ROLES else "both"
    if v not in ROLES:
        log.warning("SHAI_ROLE=%r not recognized (known: %s) — keeping "
                    "role %r", v, "/".join(ROLES), default)
        return default if default in ROLES else "both"
    return v
