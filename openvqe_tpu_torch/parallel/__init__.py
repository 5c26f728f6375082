"""The multi-device engine on ``torch.distributed``: one process per rank.

Counterpart of ``openvqe_tpu/parallel``.  ``sharded`` holds the mesh, the
two primitives through which every collective passes (``exchange`` and
``all_reduce_sum``) and the plain engine for small local blocks on the
CPU; ``sharded_stream`` composes the streaming kernels A2, C8, B6 and E15
with the mesh (on cards, always); ``sharded_gates`` holds the differentiable gate layer WSSVQE's
ansatz runs through.  Launch a sharded run with ``torchrun
--nproc_per_node=2^d`` (one process per GPU, NCCL).
"""
