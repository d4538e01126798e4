"""SAFREE's concept-subspace projection of the text embeddings.

Counterpart of ``safe_denoiser_tpu/pipeline/safree.py`` (the parts the SD3
safe-denoiser path uses): ``projection_matrix``, the projector onto the
column span of E through an f32 pseudo-inverse, and ``safree_projection``,
which finds the prompt's trigger tokens by leave-one-out distances to the
concept subspace and replaces them with their projection onto
(I - P_concept) P_masked. Plain PyTorch, f32.
"""

from __future__ import annotations

import torch


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
