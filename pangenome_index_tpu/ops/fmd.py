"""Batched FMD bidirectional extension.

backward_extend (reference: src/r-index.cpp:1395-1428) per lane:
    delta = rank6(k+s) - rank6(k)
    k'   += sum_d kp_weight[c, d] * delta[d]
    s'    = delta[c];  k' stays, fail -> (0,0,0)
    k'new = rank(k)[c] + C[c]

forward_extend is the swap+complement trick (r-index.cpp:1500-1509); we fold
it in as a flag so a single fused primitive serves both directions - one
kernel, two rank6 gathers per lane per step.
"""

from __future__ import annotations

import os

import jax.numpy as jnp

from ..utils.alphabet import COMP_CODE
from .rank import ckpt_rank6_pair, rank6
from .tables import RIndexTables

#: paired-rank locality path (ckpt_rank6_pair): same-bucket second gathers
#: clamp to a cache-resident row. Trace-time switch for A/B runs
#: (examples/filter_ab.py); default off until the A/B proves it on real
#: hardware - flipping it changes the compiled serving program.
PAIR_RANK = os.environ.get("PANIDX_PAIR_RANK", "0") != "0"


def extend(t: RIndexTables, k, kp, s, code, forward=None, rank6_fn=None,
           pair=None):
    """Batched bidirectional extension.

    k, kp, s, code: [B]. forward: bool [B] or None (all backward).
    rank6_fn(pos)->[B,6] overrides the rank provider (used by the
    model-sharded distributed engine, parallel/engine.py).
    Returns (k, kp, s) after extension; failed lanes get (0, 0, 0).

    All small-table lookups (the complement, C, the kp_weight contraction)
    and the per-lane column selects are one-hot vector math, not gathers:
    the loop was designed as gather-bound, so every per-lane gather stream
    removed from the inner loop is wall time, while 6-wide one-hot selects
    are a few vector ops. The complement permutation comes from
    utils/alphabet.COMP_CODE (the single authority for the code space).
    """
    if forward is None:
        forward = jnp.zeros(k.shape, dtype=bool)
    # pair path is local-only: a custom provider (model-sharded) owns its own
    # gathers. `pair` overrides the module default (A/B runs).
    use_pair = (PAIR_RANK if pair is None else pair) and rank6_fn is None
    if rank6_fn is None:
        rank6_fn = lambda pos: rank6(t, pos)
    code = code.astype(jnp.int32)
    sym6 = jnp.arange(6, dtype=jnp.int32)[None, :]
    oh_code = sym6 == code[:, None]                      # [B, 6] bool
    comp_row = jnp.asarray(COMP_CODE, jnp.int32)[None, :]  # static constant
    comp_val = (jnp.where(oh_code, comp_row, 0)).sum(axis=1)
    ext_code = jnp.where(forward, comp_val, code)
    comp_ext = jnp.where(forward, code, comp_val)        # comp is an involution
    oh = sym6 == ext_code[:, None]                       # [B, 6] bool
    bk = jnp.where(forward, kp, k)
    bkp = jnp.where(forward, k, kp)

    if use_pair and t is not None and t.ckpt is not None:
        r_k, r_ks = ckpt_rank6_pair(t, bk, bk + s)
    else:
        # one fused double-width rank batch (halves kernel launches per step)
        both = rank6_fn(jnp.concatenate((bk, bk + s)))
        r_k = both[: k.shape[0]]    # [B, 6]
        r_ks = both[k.shape[0] :]   # [B, 6]
    delta = r_ks - r_k

    # sum_d kp_weight[ext_code, d]*delta[d] with kp_weight[c,d]=[comp d < comp c]
    # = exclusive-prefix-sum of comp-permuted delta, read at column comp(c);
    # the permutation is static, so this is pure [B,6] vector math (no [B,6,6])
    pdelta = delta[:, COMP_CODE]
    excl = jnp.cumsum(pdelta, axis=1) - pdelta
    oh_ce = sym6 == comp_ext[:, None]
    nkp = bkp + jnp.where(oh_ce, excl, 0).sum(axis=1)

    d_c = jnp.where(oh, delta, 0).sum(axis=1)
    c_c = (jnp.where(oh, t.C[None, :6], 0)).sum(axis=1)
    nk = jnp.where(oh, r_k, 0).sum(axis=1) + c_c
    ns = d_c

    ok = ns > 0
    nk = jnp.where(ok, nk, 0)
    nkp = jnp.where(ok, nkp, 0)
    ns = jnp.where(ok, ns, 0)

    # swap back for forward lanes
    out_k = jnp.where(forward, nkp, nk)
    out_kp = jnp.where(forward, nk, nkp)
    return out_k, out_kp, ns
