"""``repro_torch.dist`` — the coded aggregation layer of the port.

  * :mod:`repro_torch.dist.mesh`        — the (pod, data) mesh on one card
    (``OneCardMesh``) or over the ranks of a world (``DistMesh``),
  * :mod:`repro_torch.dist.sharding`    — tensor parallelism: ``ShardCtx``
    and the per-leaf split rule,
  * :mod:`repro_torch.dist.launch`      — the ranks of a world, spawned
    from one process (``run_ranks``),
  * :mod:`repro_torch.dist.grad_sync`   — the two-stage coded decode
    (eqs. 25/27) over that mesh,
  * :mod:`repro_torch.dist.compression` — the int8 / int4 / fp8 codecs of
    the edge→master hop, with error feedback,
  * :mod:`repro_torch.dist.elastic`     — straggler detection and
    replanning (numpy).

Importing the package imports none of them: each is loaded where it is
used.
"""
