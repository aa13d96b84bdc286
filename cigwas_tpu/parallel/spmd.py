"""SPMD multi-chip skeleton step over a (block, marker, sample) mesh.

The reference has no distributed runtime at all (SURVEY.md §2.4); this module
is the replacement. One step runs, for a sharded batch of LD blocks:

1. one-hot genotype decode on the local (marker-shard, sample-shard) tile,
2. contingency counts: local (3m_s, n_s) x all-gathered (3m, n_s)^T matmul,
   psum over the ``sample`` axis -> each device owns full-correlation rows
   for its marker shard (tensor parallelism over the panel),
3. marker-phen / phen-phen Pearson with the same sample psum,
4. Fisher-z level-0 screen on the local panel rows,
5. a dense level-1 CI sweep over the locally-owned rows (min over all
   single-variable conditioning sets), using all-gathered panel columns,

and returns the global adjacency (all-gathered over ``marker``). Collectives:
``all_gather`` over `marker` and `sample`, `psum` over `sample`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from cigwas_tpu.ops.corr import _kendall_from_counts
from cigwas_tpu.ops.decode import geno_onehot, geno_value_valid

HIGHEST = jax.lax.Precision.HIGHEST


def _onehot(codes: jnp.ndarray, dtype=jnp.int8) -> jnp.ndarray:
    """(m, n) 2-bit codes -> (3m, n) one-hot with missing folded to zero."""
    return geno_onehot(codes, dtype=dtype).reshape(3 * codes.shape[0], -1)


def _fisher(v):
    return jnp.abs(0.5 * jnp.log(jnp.abs((1.0 + v) / (1.0 - v))))


def build_multichip_cusk_step(mesh: Mesh, th0: float, th1: float):
    """Jitted SPMD step: (codes (B, m, n) int32, phen (B, p, n) f32) -> G (B, v, v).

    codes sharded P('block', 'marker', 'sample'); phen P('block', None,
    'sample'); output replicated along marker/sample.
    """

    def local_step(codes, phen):
        # codes: (Bs, ms, ns); phen: (Bs, p, ns)
        def per_block(codes_b, phen_b):
            ms, ns = codes_b.shape
            p = phen_b.shape[0]
            X_loc = _onehot(codes_b)  # (3ms, ns) channel-major
            # tensor-parallel panel: gather the full marker axis as CODES
            # (the channel-major one-hot layout does not survive a tiled
            # all_gather over markers — channel blocks would interleave per
            # device), then one-hot locally
            codes_all = jax.lax.all_gather(codes_b, "marker", tiled=True)
            X_all = _onehot(codes_all)  # (3m, ns) channel-major
            counts = jax.lax.psum(
                jnp.dot(X_loc, X_all.T, preferred_element_type=jnp.int32),
                "sample",
            )  # (3ms, 3m) exact int32 counts from the int8 matmul
            m = codes_all.shape[0]
            C_mm = _kendall_from_counts(counts.astype(jnp.float32), ms, m)

            # marker-phen pearson on standardized traits (sample psum);
            # missing codes decode to (2.0, valid=0) so vals * valid drops them
            vals, valid = geno_value_valid(codes_b)
            s_mp = jax.lax.psum(jnp.dot(vals * valid, phen_b.T, precision=HIGHEST), "sample")
            s_p = jax.lax.psum(jnp.dot(valid, phen_b.T, precision=HIGHEST), "sample")
            n_val = jax.lax.psum(jnp.sum(valid, axis=1, keepdims=True), "sample")
            mean = jax.lax.psum(jnp.sum(vals * valid, axis=1, keepdims=True), "sample") / n_val
            var = (
                jax.lax.psum(jnp.sum(vals**2 * valid, axis=1, keepdims=True), "sample")
                / n_val
                - mean**2
            )
            std = jnp.sqrt(var)
            C_mp = (s_mp - mean * s_p) / (n_val * std)  # (ms, p)

            # phen-phen pearson
            pp_n = jax.lax.psum(jnp.full((), ns, jnp.float32), "sample")
            C_pp = jax.lax.psum(jnp.dot(phen_b, phen_b.T, precision=HIGHEST), "sample") / pp_n

            # local panel rows: markers of this shard x all variables
            C_rows = jnp.concatenate([C_mm, C_mp], axis=1)  # (ms, m + p)
            # trait rows (replicated): full marker-phen needs a gather
            C_mp_all = jax.lax.all_gather(C_mp, "marker", tiled=True)  # (m, p)
            C_trait_rows = jnp.concatenate([C_mp_all.T, C_pp], axis=1)  # (p, m+p)

            # level-0 screen on local rows
            G_rows = (_fisher(C_rows) >= th0).astype(jnp.int32)

            # level-1 dense sweep for local rows: for every pair (x in shard,
            # y), min over single conditioning variables s of z(x, y | s)
            C_full = jnp.concatenate(
                [jax.lax.all_gather(C_rows, "marker", tiled=True), C_trait_rows],
                axis=0,
            )  # (v, v)
            v = C_full.shape[0]
            shard_ix = jax.lax.axis_index("marker")
            my_rows = jax.lax.dynamic_slice(
                C_full, (shard_ix * ms, 0), (ms, v)
            )  # marker rows owned here
            # rho_{xy|s} = (c_xy - c_xs c_ys) / sqrt((1-c_xs^2)(1-c_ys^2))
            cxs = my_rows[:, None, :]  # (ms, 1, v) over s
            cys = C_full[None, :, :]  # (1, v(y), v(s))
            num = my_rows[:, :, None] - cxs * cys
            den = jnp.sqrt(jnp.abs((1.0 - cxs**2) * (1.0 - cys**2)))
            z1 = _fisher(num / den)  # (ms, v, v): pair (x, y) given s
            # mask s == x or s == y
            s_ix = jnp.arange(v)
            x_ix = shard_ix * ms + jnp.arange(ms)
            mask = (s_ix[None, None, :] == x_ix[:, None, None]) | (
                s_ix[None, None, :] == jnp.arange(v)[None, :, None]
            )
            z1 = jnp.where(mask | ~jnp.isfinite(z1), jnp.inf, z1)
            zmin1 = jnp.min(z1, axis=2)  # (ms, v)
            G_rows = G_rows * (zmin1 >= th1).astype(jnp.int32)

            # assemble global adjacency for this block
            G_markers = jax.lax.all_gather(G_rows, "marker", tiled=True)  # (m, v)
            G_traits = (_fisher(C_trait_rows) >= th0).astype(jnp.int32)
            G = jnp.concatenate([G_markers, G_traits], axis=0)
            G = G * G.T  # symmetrize (edge survives only if both sides kept)
            G = G * (1 - jnp.eye(v, dtype=jnp.int32))
            return G

        return jax.vmap(per_block)(codes, phen)

    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P("block", "marker", "sample"), P("block", None, "sample")),
        out_specs=P("block", None, None),
        check_vma=False,
    )
    return jax.jit(sharded)
