"""Synthetic data: LM token batches for the decentralized trainer, and the
paper's §6 logistic-regression data and oracles.

``TokenStream`` gives (n_nodes, R, batch, seq) batches, so each node's R
gradient-accumulation rounds see distinct microbatches (Assumption 2's
independent oracle queries), like the JAX package's ``data/synthetic.py``:
iid uniform tokens, or with ``hetero_alpha`` each node's tokens from its
own Dirichlet(alpha) marginal (the federated non-iid protocol; the
marginals are the reference's numpy draw, bit for bit).  For a VLM
(``arch_type='vlm'``) each batch also holds the stub frontend's
``prefix_embeds``, (n_nodes, R, batch, frontend_tokens, d_model) f32 of
0.02 times a standard normal, and the tokens are cut to ``seq −
frontend_tokens``, as in the reference; for the encoder-decoder
(``arch_type='audio'``) each batch also holds the stub frontend's
``frames``, (n_nodes, R, batch, encoder_seq, d_model) f32 of 0.02 times a
standard normal, beside the whole ``seq`` of tokens.  Its tokens and
embeddings come from torch generators seeded by (seed, step); the JAX
package's ``jax.random`` stream cannot be replayed in torch, so tests that
compare the two packages hand both the same batches.

:func:`logreg_dataset` and :func:`logreg_dataset_dirichlet` (with
:func:`dirichlet_partition`) make the JAX package's numpy data bit for bit
and move it to the device; :func:`logreg_loss_and_grad` gives the §6
objective's gradients in closed form.  Its stochastic oracle draws minibatch
indices from a ``torch.Generator`` on the data's device, which the JAX
package's ``jax.random.randint`` stream cannot replay.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class TokenStream:
    vocab_size: int
    n_nodes: int
    rounds: int            # R microbatches per step
    batch: int             # per-node, per-round sequences
    seq: int
    seed: int = 0
    active_vocab: int = 0  # 0 = full vocab; else the first k tokens only
    device: str = "cpu"
    hetero_alpha: Optional[float] = None   # Dirichlet(alpha) per-node token
                                           # marginals; None = iid uniform
    arch_type: str = "dense"
    d_model: int = 0
    frontend_tokens: int = 0
    encoder_seq: int = 0
    _node_logits: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)  # cached Dirichlet draw

    def node_token_logits(self) -> torch.Tensor:
        """(n_nodes, active_vocab) f32 log-probabilities: node i's token
        marginal is an independent Dirichlet(alpha) draw, the JAX package's
        numpy draw bit for bit (deterministic in seed; nodes keep their
        distribution for the whole run, so the draw and its upload to
        ``device`` happen once and are cached)."""
        if self.hetero_alpha is None:
            raise ValueError("node_token_logits requires hetero_alpha")
        if self._node_logits is None:
            hi = self.active_vocab or self.vocab_size
            rng = np.random.default_rng(
                np.random.SeedSequence((self.seed, 0xD11C)))
            probs = rng.dirichlet([self.hetero_alpha] * hi,
                                  size=self.n_nodes)
            self._node_logits = torch.from_numpy(
                np.log(np.maximum(probs, 1e-20)).astype(np.float32)).to(
                    self.device)
        return self._node_logits

    def batch_at(self, step: int) -> dict:
        """Step ``step``'s batch, the same on every call.  iid tokens are
        drawn on the CPU (a few KB) and moved to ``device``; with
        ``hetero_alpha`` each node's tokens are categorical draws from its
        marginal (:meth:`node_token_logits`), made on ``device`` by a
        generator there.  A VLM's ``prefix_embeds`` are drawn on ``device``
        by a generator seeded by (seed, step, 1), where the reference folds
        1 into the step's key, and an encoder-decoder's ``frames`` by one
        seeded by (seed, step, 2), where it folds in 2."""
        seed = int(np.random.SeedSequence((self.seed, step)).generate_state(1)[0])
        shape = (self.n_nodes, self.rounds, self.batch, self.seq)
        if self.hetero_alpha is not None:
            probs = self.node_token_logits().exp()
            gen = torch.Generator(device=probs.device).manual_seed(seed)
            tokens = torch.multinomial(probs, math.prod(shape[1:]),
                                       replacement=True,
                                       generator=gen).view(shape)
        else:
            gen = torch.Generator().manual_seed(seed)
            hi = self.active_vocab or self.vocab_size
            tokens = torch.randint(0, hi, shape, generator=gen).to(
                self.device)
        out = {"tokens": tokens}
        if self.arch_type == "vlm":
            pseed = int(np.random.SeedSequence(
                (self.seed, step, 1)).generate_state(1)[0])
            gen = torch.Generator(device=self.device).manual_seed(pseed)
            out["prefix_embeds"] = 0.02 * torch.randn(
                shape[:3] + (self.frontend_tokens, self.d_model),
                generator=gen, device=self.device)
            out["tokens"] = tokens[..., :self.seq - self.frontend_tokens]
        elif self.arch_type == "audio":
            fseed = int(np.random.SeedSequence(
                (self.seed, step, 2)).generate_state(1)[0])
            gen = torch.Generator(device=self.device).manual_seed(fseed)
            out["frames"] = 0.02 * torch.randn(
                shape[:3] + (self.encoder_seq, self.d_model), generator=gen,
                device=self.device)
        return out


def token_stream_for(cfg, n_nodes: int, rounds: int, batch: int, seq: int,
                     seed: int = 0, active_vocab: int = 0,
                     hetero_alpha: Optional[float] = None,
                     device: str = "cpu") -> TokenStream:
    return TokenStream(vocab_size=cfg.vocab_size, n_nodes=n_nodes,
                       rounds=rounds, batch=batch, seq=seq, seed=seed,
                       active_vocab=active_vocab, device=device,
                       hetero_alpha=hetero_alpha, arch_type=cfg.arch_type,
                       d_model=cfg.d_model,
                       frontend_tokens=cfg.frontend_tokens,
                       encoder_seq=cfg.encoder_seq)


# ---------------------------------------------------------------------------
# Dirichlet node partitions (federated non-iid protocol)
# ---------------------------------------------------------------------------

def dirichlet_partition(labels: np.ndarray, n_nodes: int, alpha: float,
                        seed: int = 0) -> list:
    """Partition a labelled pool across nodes with Dirichlet(alpha) class
    proportions (Hsu et al.): for each class, sample p ~ Dir(alpha * 1_n)
    and deal that class's examples to nodes in proportion p.  Every example
    is assigned to exactly one node; every node receives at least one
    example (the emptiest node steals from the fullest if a draw starves
    it).  Returns a list of ``n_nodes`` index arrays.  The JAX package's
    numpy, bit for bit.
    """
    labels = np.asarray(labels)
    rng = np.random.default_rng(np.random.SeedSequence((seed, 0xD117)))
    parts = [[] for _ in range(n_nodes)]
    for cls in np.unique(labels):
        idx = np.flatnonzero(labels == cls)
        rng.shuffle(idx)
        p = rng.dirichlet([alpha] * n_nodes)
        cuts = (np.cumsum(p) * len(idx)).astype(int)[:-1]
        for node, chunk in enumerate(np.split(idx, cuts)):
            parts[node].extend(chunk.tolist())
    for node in range(n_nodes):  # no node may be empty
        if not parts[node]:
            donor = int(np.argmax([len(p) for p in parts]))
            parts[node].append(parts[donor].pop())
    return [np.sort(np.asarray(p, dtype=int)) for p in parts]


def logreg_dataset_dirichlet(n_nodes: int, m: int, d: int, *, alpha: float,
                             margin: float = 1.0, seed: int = 0,
                             device="cpu"):
    """§6-style binary data partitioned by :func:`dirichlet_partition`
    instead of the fixed 80/20 split: the label skew per node is governed
    by ``alpha`` (small = near-single-class nodes).  Each node holds ``m``
    samples drawn with replacement from its Dirichlet share so shapes stay
    (n_nodes, m, d) / (n_nodes, m) like :func:`logreg_dataset`.  The numpy
    draws are the JAX package's, bit for bit; the arrays move to ``device``
    last.
    """
    rng = np.random.default_rng(seed)
    total = n_nodes * m
    w_star = rng.normal(size=d) / np.sqrt(d)
    y_all = np.where(rng.random(total) < 0.5, 1.0, -1.0)
    base = rng.normal(size=(total, d)).astype(np.float32)
    proj = base @ w_star
    base += np.outer((margin * y_all - proj) * 0.9, w_star) / (w_star @ w_star)
    parts = dirichlet_partition(y_all, n_nodes, alpha, seed=seed)
    feats = np.zeros((n_nodes, m, d), np.float32)
    labels = np.zeros((n_nodes, m), np.float32)
    for i, part in enumerate(parts):
        take = rng.choice(part, size=m, replace=True)
        feats[i] = base[take]
        labels[i] = y_all[take]
    return (torch.from_numpy(feats).to(device),
            torch.from_numpy(labels).to(device))


# ---------------------------------------------------------------------------
# Paper §6: heterogeneous logistic-regression data
# ---------------------------------------------------------------------------

def logreg_dataset(n_nodes: int, m: int, d: int, *, positive_frac: float = 0.8,
                   margin: float = 1.0, seed: int = 0, device="cpu"):
    """Synthetic linearly-separable-ish binary data, partitioned so that the
    first half of the nodes hold ``positive_frac`` positive datapoints and
    the second half the mirror (the paper's 80/20 protocol).  The numpy
    draws are the JAX package's, bit for bit.

    Returns (H, y) on ``device``: H (n_nodes, m, d) f32 features, y
    (n_nodes, m) f32 in {-1, +1}.
    """
    rng = np.random.default_rng(seed)
    w_star = rng.normal(size=d) / np.sqrt(d)
    feats = np.zeros((n_nodes, m, d), np.float32)
    labels = np.zeros((n_nodes, m), np.float32)
    for i in range(n_nodes):
        frac = positive_frac if i < n_nodes // 2 else 1.0 - positive_frac
        n_pos = int(round(frac * m))
        y = np.concatenate([np.ones(n_pos), -np.ones(m - n_pos)])
        rng.shuffle(y)
        base = rng.normal(size=(m, d)).astype(np.float32)
        # push features to the correct side of the separator + noise
        proj = base @ w_star
        base += np.outer((margin * y - proj) * 0.9, w_star) / (w_star @ w_star)
        feats[i] = base
        labels[i] = y
    return (torch.from_numpy(feats).to(device),
            torch.from_numpy(labels).to(device))


def logreg_loss_and_grad(rho: float):
    """Loss/gradient factory for the §6 objective:
    f_i(x) = mean_j ln(1 + exp(-y_ij <h_ij, x>)) + rho * sum_k x_k^2/(1+x_k^2).

    Returns (loss_i, full_grad, stochastic_grad, global_loss,
    global_grad_norm_sq), the JAX package's five.  Gradients are closed
    form: (1/b) sum_j -y_j sigmoid(z_j) h_j + rho * 2x/(1+x^2)^2 with
    z = -y <h, x>, batched over nodes with ``bmm``.
    """

    def reg_grad(x):
        return rho * 2.0 * x / (1.0 + x ** 2) ** 2

    def loss_i(x, H_i, y_i):
        z = -y_i * (H_i @ x)
        data = torch.logaddexp(torch.zeros_like(z), z).mean()
        return data + rho * (x ** 2 / (1.0 + x ** 2)).sum()

    def node_grads(xs, H, y):
        """xs (n, d); H (n, b, d); y (n, b) -> per-node gradients (n, d)."""
        z = -y * torch.bmm(H, xs.unsqueeze(-1)).squeeze(-1)
        coef = -y * torch.sigmoid(z) / H.shape[1]
        return torch.bmm(coef.unsqueeze(1), H).squeeze(1) + reg_grad(xs)

    def full_grad(xs, H, y):
        """xs: (n, d) stacked models -> per-node full-batch gradients."""
        return node_grads(xs, H, y)

    def stochastic_grad(xs, H, y, gen, batch: int):
        """Minibatch oracle: ``batch`` indices per node drawn from the
        ``torch.Generator`` ``gen`` (on H's device)."""
        n, m, _ = H.shape
        idx = torch.randint(0, m, (n, batch), generator=gen, device=H.device)
        # index rows by (node, sample) pairs: an index broadcast over d would
        # be an (n, batch, d) int64 tensor, twice the minibatch's own size
        rows = torch.arange(n, device=H.device)[:, None]
        return node_grads(xs, H[rows, idx], y[rows, idx])

    def global_loss(x, H, y):
        z = -y * (H @ x)
        data = torch.logaddexp(torch.zeros_like(z), z).mean()
        return data + rho * (x ** 2 / (1.0 + x ** 2)).sum()

    def global_grad_norm_sq(x, H, y):
        """||grad of the mean of the n local objectives at x||^2 over all
        n·m samples; the data enter once, as one (n·m, d) product each
        way."""
        n, m, d = H.shape
        flat = H.reshape(n * m, d)
        yf = y.reshape(n * m)
        coef = -yf * torch.sigmoid(-yf * (flat @ x)) / (n * m)
        g = coef @ flat + reg_grad(x)
        return (g ** 2).sum()

    return loss_i, full_grad, stochastic_grad, global_loss, global_grad_norm_sq

