"""Expert parallelism: MoE experts sharded over a mesh axis.

DeepSeek-V2 interleaves MLA attention with routed-expert FFNs
(``ops.moe``); at scale the expert weights are the dominant bytes, so they
shard over their own mesh axis ("ep", or the "tp" axis doubling as the
expert pool — pass ``axis="tp"``).  The reference has no MoE at all
(SURVEY.md §2.3), so this layer is beyond-reference capability.

Formulation: the masked-dense MoE (``ops.moe.moe_ffn_dense``) distributes
over the expert axis — every chip routes ALL tokens (the router is a
[h, E] matvec, negligible), applies only its E/ep local experts with the
router's gate columns for those experts, and the cross-expert sum becomes
one ``psum``.  No all-to-all, no capacity factors, no token dropping: for
the decode/prefill shapes this framework serves, shipping the [T, h]
activations through a psum is far cheaper than shipping tokens to experts
(the scaling-book "weight-stationary" regime).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from clusterfusion.ops.moe import _swiglu, route_top_k


def make_ep_moe_ffn(mesh: Mesh, top_k: int = 2, *, axis: str = "ep",
                    norm_topk_prob: bool = True,
                    routed_scaling_factor: float = 1.0):
    """Build a jitted expert-parallel MoE FFN.

    Returns ``f(x [T, h], router_w [h, E], w13_all [E, 2, h, f],
    w2_all [E, f, h]) -> [T, h]`` with the expert arrays sharded
    ``P(axis)`` on their leading axis.  Numerically equal to
    ``moe_ffn_dense`` (tests/test_parallel.py::test_expert_sharded_moe...).
    """
    ep = mesh.shape[axis]

    def local(x, router_w, w13_l, w2_l):
        # full router on every chip; each chip applies only its local
        # experts' gate columns
        gates, _ = route_top_k(x, router_w, top_k,
                               norm_topk_prob=norm_topk_prob,
                               routed_scaling_factor=routed_scaling_factor)
        El = w13_l.shape[0]
        e0 = jax.lax.axis_index(axis) * El
        g_l = jax.lax.dynamic_slice(gates, (0, e0), (x.shape[0], El))

        def body(acc, ew):
            w13_e, w2_e, g = ew
            y = _swiglu(x, w13_e.astype(x.dtype), w2_e.astype(x.dtype))
            return acc + g[:, None] * y, None

        # initial carry must be marked varying over the manual expert axis
        # (the body output varies with the chip-local expert weights)
        acc0 = jax.lax.pcast(jnp.zeros(x.shape, jnp.float32), (axis,),
                             to="varying")
        acc, _ = jax.lax.scan(body, acc0, (w13_l, w2_l, g_l.T))
        return jax.lax.psum(acc, axis).astype(x.dtype)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(), P(), P(axis), P(axis)), out_specs=P(),
                   check_vma=False)

    def ep_moe_ffn(x, router_w, w13_all, w2_all):
        E = w13_all.shape[0]
        assert E % ep == 0, f"ep={ep} must divide n_experts={E}"
        return fn(x, router_w, w13_all, w2_all)

    return jax.jit(ep_moe_ffn)
