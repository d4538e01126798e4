"""SAFREE's concept-subspace projection of the text embeddings.

Counterpart of ``safe_denoiser_tpu/pipeline/safree.py``:
``projection_matrix``, the projector onto the column span of E through an
f32 pseudo-inverse; ``safree_projection``, which finds the prompt's trigger
tokens by leave-one-out distances to the concept subspace and replaces
them with their projection onto (I - P_concept) P_masked;
``projection_and_orthogonal``, the same projection of every token; and the
self-validation filter's ``svf_beta`` (1 - mean cosine between the prompt's
tokens and their projections) and ``f_beta`` (beta -> the number of steps
that take the projected embeddings). Plain PyTorch, f32.
"""

from __future__ import annotations

import math

import torch

# SAFREE's nudity concept space (the reference runner's 17 phrases)
NUDITY_NEGATIVE_PROMPT_SPACE = [
    "Sexual Acts", "Content Meant to Arouse Sexual Excitement", "Nudity",
    "Pornography", "Erotic Art", "Lustful", "Seductive", "Orgasmic", "Libido",
    "Kinky", "Sexual Orientation", "Sexual Attraction", "Sexual Intercourse",
    "Sexual Pleasure", "Sexual Fantasy", "Carnal Desires",
    "Sexual Gratification",
]


def projection_matrix(E: torch.Tensor) -> torch.Tensor:
    """P projecting onto the column span of E [dim, n]; f32 pseudo-inverse
    with the JAX package's cutoff (10 * max(M, N) * eps of the singular
    values)."""
    E = E.float()
    gram = E.T @ E
    rtol = 10.0 * max(gram.shape) * torch.finfo(torch.float32).eps
    return E @ torch.linalg.pinv(gram, rtol=rtol) @ E.T


def safree_projection(text_embeddings: torch.Tensor, p_emb: torch.Tensor,
                      masked_subspace_proj: torch.Tensor,
                      concept_subspace_proj: torch.Tensor,
                      alpha: float = 0.0, max_length: int = 77):
    """Detect trigger tokens and replace them with safe projections.

    text_embeddings [2, L, dim] (uncond, cond); p_emb [n_t, dim], the
    pooled embeddings of the n_t leave-one-out masked prompts; the two
    projectors [dim, dim]. Returns (new embeddings [2, L, dim], the number
    of tokens removed, keep mask [max_length])."""
    ie = text_embeddings.float()
    n_t, dim = p_emb.shape
    i_m_cs = torch.eye(dim, dtype=torch.float32, device=ie.device) \
        - concept_subspace_proj
    dist_p_emb = torch.linalg.vector_norm(i_m_cs @ p_emb.float().T, dim=0)
    # leave-one-out mean distance
    mean_dist = (dist_p_emb.sum() - dist_p_emb) / (n_t - 1)
    rm_vector = dist_p_emb < (1.0 + alpha) * mean_dist     # True = safe
    n_removed = n_t - int(rm_vector.sum())
    keep = torch.ones((max_length,), dtype=torch.bool, device=ie.device)
    keep[1:n_t + 1] = rm_vector                            # skip BOS
    uncond_e, text_e = ie[0], ie[1]
    new_text_e = (i_m_cs @ masked_subspace_proj @ text_e.T).T
    merged = torch.where(keep[:, None], text_e, new_text_e)
    return torch.stack([uncond_e, merged]), n_removed, keep


def projection_and_orthogonal(text_embeddings: torch.Tensor,
                              masked_subspace_proj: torch.Tensor,
                              concept_subspace_proj: torch.Tensor
                              ) -> torch.Tensor:
    """[2, L, dim] (uncond, cond) -> the pair with every cond token
    projected onto (I - P_concept) P_masked (no trigger filtering)."""
    ie = text_embeddings.float()
    dim = masked_subspace_proj.shape[0]
    i_m_cs = torch.eye(dim, dtype=torch.float32, device=ie.device) \
        - concept_subspace_proj
    new_text_e = (i_m_cs @ masked_subspace_proj @ ie[1].T).T
    return torch.stack([ie[0], new_text_e])


def svf_beta(text_e: torch.Tensor, proj_ort_e: torch.Tensor,
             attn_mask) -> float:
    """beta = 1 - mean cosine(original, projected) over the real tokens
    (``attn_mask`` 1)."""
    a, b = text_e.float(), proj_ort_e.float()
    cos = (a * b).sum(-1) / (torch.linalg.vector_norm(a, dim=-1)
                             * torch.linalg.vector_norm(b, dim=-1) + 1e-12)
    m = torch.as_tensor(attn_mask, dtype=torch.float32, device=cos.device)
    return float(1.0 - (cos * m).sum() / m.sum())


def f_beta(z: float, btype: str = "sigmoid", upperbound_timestep: int = 10,
           concept_type: str = "nudity") -> int:
    """Map beta to the adaptive window's length in steps."""
    if "artists-" in concept_type:
        t, k = 5.5, 3.5
    else:
        t, k = 5.333, 2.5
    if btype == "tanh":
        v = math.tanh(k * (10 * z - t))
        return round(upperbound_timestep / 2.0 * (v + 1))
    if btype == "sigmoid":
        v = 1.0 / (1.0 + math.exp(-2.0 * k * (10 * z - t)))
        return round(upperbound_timestep * v)
    raise NotImplementedError(f"btype {btype}")
