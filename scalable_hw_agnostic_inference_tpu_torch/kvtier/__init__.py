"""KV tiering: a host-RAM offload tier behind the paged KV cache's prefix
cache.

Port of ``scalable_hw_agnostic_inference_tpu/kvtier/``. Eviction of a
cached block becomes a demotion instead of a deletion:

- ``pool``      the bounded host-RAM block pool (numpy-backed, fully
                CPU-testable) and the async copy-out worker thread;
- ``restore``   the device<->host block movers in torch: one
                ``index_select`` per layer into a fresh stacked tensor
                (demotion), one in-place ``index_copy_`` per layer into
                the pool tensors (restore);
- ``affinity``  stdlib-only prompt-affinity digests, advertised on
                ``/stats``.

Env knobs: ``SHAI_KVTIER`` (gate, default off), ``SHAI_KVTIER_BYTES``
(host pool capacity, default 256 MiB), ``SHAI_KVTIER_ASYNC`` (copy-out
worker, default on; ``0`` copies synchronously).
"""

from .affinity import AffinityTracker, prompt_affinity  # noqa: F401
