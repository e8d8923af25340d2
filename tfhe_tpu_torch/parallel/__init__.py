"""Multi-device scale-out of the batched bootstraps on ``torch.distributed``
(the counterpart of ``tfhe_tpu.parallel``).

The JAX package is single-controller: one process places arrays on a mesh
of devices and ``shard_map`` runs a per-device body.  Here every device is
its own process (a rank, one per card under ``torchrun``, or several ranks
sharing one card under gloo), and each rank runs that per-device body on
its own slice:

  dp  ciphertext batch: each rank bootstraps its B/dp rows, no collectives;
  ep  (``shard``) the external product's digit-row axis J = (k+1)*l: each
      rank holds J/ep of every TRGSW operand and contracts its digit slice,
      one all-reduce a blind-rotation step; the key-switch tables split
      their contracted one-hot rows the same way, one all-reduce a switch;
  tp  (``mesh``) the gate bootstrap with its key replicated and only the
      key switch's rows split, one all-reduce a launch.

Every path is exact integer arithmetic and every all-reduce is exact mod
2^32 or 2^64 (``mesh.all_reduce_exact``), so a sharded output equals the
single-device one bit for bit.

  mesh       ``Mesh`` (ranks on a (dp, ep) or (dp, tp) grid and their
             process groups), ``make_mesh``, ``all_reduce_exact`` and the
             tp formulation of the gate bootstrap;
  shard      the dp x ep gate and circuit bootstraps and their key
             placement;
  multihost  start-up (``initialize``, ``launch``), a mesh that keeps every
             ep group inside one host, host-local placement and gather.
"""
