"""Distance-aware 2-state HMM over SNP sequences (JAX, scan-based).

Device counterpart of the reference's vestigial HMM module
(/root/reference/shared/HMM.cpp — shipped with ngsLD for the sibling
ngsF-HMM-style tools but not compiled into the binary, Makefile:5,14).
Provides the same capability surface, redesigned around lax.scan:

  * forward / backward       — log-space filtering over sites with
                               distance-dependent transitions
                               (HMM.cpp:6-75)
  * viterbi                  — most likely state path (HMM.cpp:115-140)
  * calc_trans               — P(k->l | d) = (1-e^{-alpha d}) q_l
                               [+ e^{-alpha d} if k==l] (HMM.cpp:130-140)
  * emission_hwe             — single-site HWE-prior emission
                               (HMM.cpp:144-155)
  * emission_ld              — two-locus LD emission from haplotype
                               frequencies via the 9-entry joint genotype
                               table (HMM.cpp:175-208, 211-236)

All functions are jittable and vmap-able over individuals/regions. States
are generic (n_states from q_prop), matching the reference's API.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def log_trans_matrix(q_prop: jnp.ndarray, alpha: float, dist: jnp.ndarray):
    """(..., K, K) log transition matrices for each distance.
    T[k,l] = (1 - e^{-alpha d}) q_l + [k==l] e^{-alpha d}."""
    K = q_prop.shape[-1]
    stay = jnp.exp(-alpha * dist)[..., None, None]
    base = (1 - stay) * q_prop[None, :]
    return jnp.log(base + stay * jnp.eye(K))


def forward(q_prop, alpha, log_emission, pos_dist):
    """Log-space forward pass.

    log_emission: (L, K) per-site log emission; pos_dist: (L,) distance to
    the previous site (pos_dist[0] unused). Returns (log-likelihood,
    (L, K) forward table including the init row convention of the
    reference: row 0 is the prior, emissions apply from site 1..L as in
    HMM.cpp:6-29 — here every row carries its emission).
    """
    T = log_trans_matrix(q_prop, alpha, pos_dist)  # (L, K, K)
    f0 = jnp.log(q_prop) + log_emission[0]

    def step(f_prev, inp):
        Ts, e = inp
        f = jax.nn.logsumexp(f_prev[:, None] + Ts, axis=0) + e
        return f, f

    _, rows = jax.lax.scan(step, f0, (T[1:], log_emission[1:]))
    table = jnp.concatenate([f0[None], rows], axis=0)
    return jax.nn.logsumexp(table[-1]), table


def backward(q_prop, alpha, log_emission, pos_dist):
    """Log-space backward pass; returns (log-likelihood, (L, K) table)."""
    K = q_prop.shape[-1]
    T = log_trans_matrix(q_prop, alpha, pos_dist)

    def step(b_next, inp):
        Ts, e = inp
        b = jax.nn.logsumexp(Ts + (e + b_next)[None, :], axis=1)
        return b, b

    bL = jnp.zeros(K)
    _, rows = jax.lax.scan(step, bL, (T[1:], log_emission[1:]), reverse=True)
    table = jnp.concatenate([rows, bL[None]], axis=0)
    ll = jax.nn.logsumexp(jnp.log(q_prop) + log_emission[0] + table[0])
    return ll, table


def posterior(q_prop, alpha, log_emission, pos_dist):
    """Per-site posterior state probabilities (forward-backward smoother)."""
    ll, fw = forward(q_prop, alpha, log_emission, pos_dist)
    _, bw = backward(q_prop, alpha, log_emission, pos_dist)
    return jnp.exp(fw + bw - ll)


def viterbi(q_prop, alpha, log_emission, pos_dist):
    """Most likely state path; returns (path_logprob, (L,) int32 path)."""
    T = log_trans_matrix(q_prop, alpha, pos_dist)
    v0 = jnp.log(q_prop) + log_emission[0]

    def step(v_prev, inp):
        Ts, e = inp
        scores = v_prev[:, None] + Ts
        back = jnp.argmax(scores, axis=0)
        v = jnp.max(scores, axis=0) + e
        return v, (v, back)

    v_last, (_, backs) = jax.lax.scan(step, v0, (T[1:], log_emission[1:]))
    last = jnp.argmax(v_last)

    def trace(state, back):
        prev = back[state]
        return prev, state

    first, path_rest = jax.lax.scan(trace, last, backs, reverse=True)
    path = jnp.concatenate([first[None], path_rest]).astype(jnp.int32)
    return v_last[last], path


# --------------------------------------------------------------- emissions

def hwe_genotype_logfreq(maf, F):
    """HWE genotype frequencies with inbreeding F (calc_HWE semantics,
    gen_func.cpp:938-957, incl. the F==1 heterozygote guard)."""
    g0 = (1 - maf) ** 2 + (1 - maf) * maf * F
    g1 = 2 * (1 - maf) * maf - 2 * (1 - maf) * maf * F
    g2 = maf ** 2 + (1 - maf) * maf * F
    g1 = jnp.where(F == 1.0, 1e-300, g1)
    return jnp.log(jnp.stack([g0, g1, g2], axis=-1))


def emission_hwe(gl_log, maf, F):
    """log P(reads | maf, F) = logsumexp_g gl[g] + log HWE_g (HMM.cpp:144-155).
    gl_log (..., 3) log-GLs; maf, F broadcastable."""
    return jax.nn.logsumexp(gl_log + hwe_genotype_logfreq(maf, F), axis=-1)


def joint_geno_logprob(hap_freq, F: int = 0):
    """(3, 3) joint genotype probability table P(G_prev, G_curr | hap_freq)
    (HMM.cpp:211-236). F=0: outcrossed (products of haplotype draws);
    F=1: fully inbred (single haplotype draw, hets impossible)."""
    h = hap_freq
    if F == 0:
        t = jnp.stack([
            jnp.stack([h[0] ** 2, 2 * h[0] * h[1], h[1] ** 2]),
            jnp.stack([2 * h[0] * h[2],
                       2 * (h[0] * h[3] + h[1] * h[2]), 2 * h[1] * h[3]]),
            jnp.stack([h[2] ** 2, 2 * h[2] * h[3], h[3] ** 2]),
        ])
    else:
        z = jnp.zeros(())
        t = jnp.stack([
            jnp.stack([h[0], z, h[1]]),
            jnp.stack([z, z, z]),
            jnp.stack([h[2], z, h[3]]),
        ])
    return jnp.log(t)


def emission_ld(hap_freq, gl_prev_log, gl_curr_log, maf_prev, F: int = 0):
    """Two-locus LD emission (HMM.cpp:175-208): log of
    sum_{gp,gc} P(gp,gc|hap) L(gp) L(gc), conditioned on the previous
    site's single-locus HWE emission."""
    joint = joint_geno_logprob(hap_freq, F)
    ll = jax.nn.logsumexp(joint + gl_prev_log[:, None] + gl_curr_log[None, :])
    return ll - emission_hwe(gl_prev_log, maf_prev, jnp.float32(F))
