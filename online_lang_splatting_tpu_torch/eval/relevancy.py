"""LERF-protocol open-vocabulary relevancy (port of eval/relevancy.py).

Text queries are scored against the four canonical negatives ("object",
"things", "stuff", "texture") with a pairwise softmax(10 sim) and the
hardest negative; `get_max_across` gives (levels, prompts, H, W)
relevancy maps and `get_semantic_map` an argmax classifier with optional
negative rejection. Embeddings live on one device.
"""

from __future__ import annotations

import numpy as np
import torch

NEGATIVES = ("object", "things", "stuff", "texture")


def _l2n(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=eps)


def pairwise_relevancy(embed: torch.Tensor, pos: torch.Tensor,
                       neg: torch.Tensor) -> torch.Tensor:
    """embed (N, D) -> (N, P): for every positive, softmax([10 pos, 10 neg])
    over each (positive, negative) pair, the positive's probability at the
    hardest negative."""
    out = embed @ torch.cat([pos, neg]).T  # (N, P+G)
    p, g = out[:, : pos.shape[0]], out[:, pos.shape[0]:]
    shape = (*p.shape, g.shape[1])
    sims = torch.stack([p[:, :, None].expand(shape), g[:, None, :].expand(shape)], dim=-1)
    return torch.softmax(10 * sims, dim=-1)[..., 0].amin(dim=-1)


class CLIPRelevancy:
    """Normalized positive/negative text embeddings and map scoring.

    `embed_table` ({query text: (D,) embedding}) serves queries without a
    text tower (precomputed CLIP text embeddings, or the synthetic class
    embeddings of eval/synthetic_miou.py); queries missing from it go
    through `text_tower` (a models/text_tower TextTower) and `tokenizer`.
    """

    def __init__(self, text_tower=None, tokenizer=None, *, pos_embeds=None,
                 neg_embeds=None, embed_table=None, device="cuda"):
        self.device = torch.device(device)
        self._text_tower = text_tower
        self._tokenizer = tokenizer
        self._embed_table = (
            {k: np.asarray(v, np.float32) for k, v in embed_table.items()}
            if embed_table else None)
        self.pos_embeds = None if pos_embeds is None else _l2n(self._t(pos_embeds))
        if neg_embeds is not None:
            self.neg_embeds = _l2n(self._t(neg_embeds))
        elif text_tower is not None or self._embed_table is not None:
            self.neg_embeds = self._encode(list(NEGATIVES))
        else:
            raise ValueError("need a text tower or precomputed neg_embeds")
        self.positives: list[str] = []
        self.semantic_embeds = None

    def _t(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x, np.float32)
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _encode(self, texts) -> torch.Tensor:
        table = self._embed_table or {}
        missing = [t for t in texts if t not in table]
        if missing and self._text_tower is None:
            raise KeyError(f"queries missing from embed_table and no text tower loaded: {missing}")
        tower = iter(self._tower_encode(missing)) if missing else iter(())
        # Table hits keep their precomputed embeddings; only the misses go
        # through the tower.
        return torch.stack([_l2n(self._t(table[t])) if t in table else next(tower)
                            for t in texts])

    @torch.no_grad()
    def _tower_encode(self, texts) -> torch.Tensor:
        tokens = torch.as_tensor(self._tokenizer(texts), device=self.device)
        return _l2n(self._text_tower(tokens))

    def set_positives(self, texts):
        self.positives = list(texts)
        self.pos_embeds = self._encode(self.positives)

    def set_positive_embeds(self, embeds, names=None):
        self.pos_embeds = _l2n(self._t(embeds))
        self.positives = names or [str(i) for i in range(len(embeds))]

    def set_semantics(self, texts):
        self.semantic_labels = list(texts)
        self.semantic_embeds = self._encode(texts)

    def get_relevancy(self, embed: torch.Tensor, positive_id: int) -> torch.Tensor:
        """embed (N, D) -> (N, 2) [pos, neg] pairwise softmax probabilities
        at the hardest negative for one positive."""
        phrases = torch.cat([self.pos_embeds, self.neg_embeds])
        output = embed @ phrases.T
        pos = output[:, positive_id: positive_id + 1]
        neg = output[:, len(self.pos_embeds):]
        sims = torch.stack([pos.expand(-1, neg.shape[1]), neg], dim=-1)
        softmax = torch.softmax(10 * sims, dim=-1)
        best = torch.argmin(softmax[..., 0], dim=1)
        return softmax[torch.arange(embed.shape[0], device=embed.device), best]

    def relevancy_all(self, embed: torch.Tensor) -> torch.Tensor:
        """embed (N, D) -> (prompts, N) positive probabilities, the [:, 0]
        column of `get_relevancy` for every positive at once."""
        return pairwise_relevancy(embed, self.pos_embeds, self.neg_embeds).T

    def get_max_across(self, sem_map: torch.Tensor) -> torch.Tensor:
        """sem_map (levels, H, W, D) -> relevancy (levels, prompts, H, W)."""
        n_levels, h, w, d = sem_map.shape
        flat = self._t(sem_map).reshape(n_levels, -1, d)
        return torch.stack([self.relevancy_all(flat[i]).reshape(-1, h, w)
                            for i in range(n_levels)])

    def get_semantic_map(self, sem_map: torch.Tensor,
                         with_negatives: bool = False) -> torch.Tensor:
        """(levels, H, W, D) -> (levels, H, W) int labels, -1 = background.
        with_negatives appends the LERF negatives so off-vocabulary points
        land in background."""
        n_levels, h, w, d = sem_map.shape
        pos_num = self.semantic_embeds.shape[0]
        phrases = (torch.cat([self.semantic_embeds, self.neg_embeds])
                   if with_negatives else self.semantic_embeds)
        logits = self._t(sem_map).reshape(n_levels, -1, d) @ phrases.T
        pred = torch.argmax(torch.softmax(10 * logits, dim=-1), dim=-1)
        pred = torch.where(pred >= pos_num, -1, pred)
        return pred.reshape(n_levels, h, w)
