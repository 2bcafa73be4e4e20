"""Mesh / sharding layer.

Multi-card scaling of the verification plane: a height's validator
signatures are split along one batch axis of a `Mesh` (an ordered list of
devices), each device verifies its shard with the kernels of ops/, counts
its failures with csrc/fail_count.cu, and the verdict is the AND-reduce
`sum(fail counts) == 0`. On one controller the counts are copied to the
mesh's first device and summed there; across processes one
`torch.distributed.all_reduce` (NCCL between cards, gloo on the host)
sums them, where the JAX package's programs `psum` over ICI.
"""
