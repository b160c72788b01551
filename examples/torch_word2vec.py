"""Skip-gram word2vec with a sparse gradient allreduce on the PyTorch port:
the counterpart of ``examples/jax_word2vec.py`` (the reference's
tensorflow_word2vec, whose embedding gradients arrive as IndexedSlices and
are exchanged by allgather).

Each rank computes the gradient ROWS of the embedding indices in its
slice of the global batch; ``collectives.sparse_allreduce`` allgathers the
(values, indices) pairs, divided by the world size, and every rank
scatter-adds the combined update into its replicated tables: only touched
rows travel. Every rank draws the same global batch from the same seed,
as the JAX example's devices share it, so for the same world size the two
train the same tables on the same data. On the card unless ``--device
cpu``:

    python -m horovod_tpu_torch.runner -np 2 -- \
        python examples/torch_word2vec.py --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # run from repo without install

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel import collectives

VOCAB = int(os.environ.get("W2V_VOCAB", 2000))
DIM = int(os.environ.get("W2V_DIM", 64))
BATCH = int(os.environ.get("W2V_BATCH", 128))
NEG = 5          # negative samples per positive
EPOCHS = int(os.environ.get("W2V_EPOCHS", 3))
STEPS = int(os.environ.get("W2V_STEPS", 20))


def synthetic_skipgrams(rng, n):
    """Zipf-ish centers with contexts a small offset away, so the embedding
    has structure to learn."""
    centers = (rng.zipf(1.5, size=n) - 1) % VOCAB
    contexts = (centers + rng.integers(1, 4, size=n)) % VOCAB
    return centers.astype(np.int32), contexts.astype(np.int32)


def local_grads(emb, ctx, centers, contexts, negatives):
    """The negative-sampling loss and the gradients of the touched rows
    only (the IndexedSlices analog): (loss, d centers, d contexts, d
    negatives)."""
    c_rows = emb.index_select(0, centers).requires_grad_()
    pos_rows = ctx.index_select(0, contexts).requires_grad_()
    neg_rows = ctx.index_select(0, negatives.reshape(-1)).reshape(
        *negatives.shape, DIM).requires_grad_()
    pos_logit = (c_rows * pos_rows).sum(-1)
    neg_logit = torch.einsum("bd,bkd->bk", c_rows, neg_rows)
    loss = -F.logsigmoid(pos_logit).mean() - F.logsigmoid(-neg_logit).sum(-1).mean()
    g_c, g_pos, g_neg = torch.autograd.grad(loss, (c_rows, pos_rows, neg_rows))
    return loss.detach(), g_c, g_pos, g_neg


def main(argv=None):
    p = argparse.ArgumentParser(description="torch word2vec, sparse allreduce")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    hvd.init(device=args.device)
    dev, size, rank = hvd.device(), hvd.size(), hvd.rank()
    rng = np.random.default_rng(1234)
    emb = torch.from_numpy(rng.normal(0, 0.1, (VOCAB, DIM)).astype(np.float32)).to(dev)
    ctx = torch.from_numpy(rng.normal(0, 0.1, (VOCAB, DIM)).astype(np.float32)).to(dev)
    lr = 0.05 * size

    def mine(a):
        return torch.from_numpy(a[rank * BATCH:(rank + 1) * BATCH].astype(np.int64)).to(dev)

    for epoch in range(EPOCHS):
        losses = []
        for _ in range(STEPS):
            centers, contexts = synthetic_skipgrams(rng, BATCH * size)
            negatives = rng.integers(0, VOCAB, (BATCH * size, NEG)).astype(np.int32)
            c, o, n = mine(centers), mine(contexts), mine(negatives)
            loss, g_c, g_pos, g_neg = local_grads(emb, ctx, c, o, n)
            # Sparse allreduce: ship (rows, indices), not the dense tables.
            v_c, i_c = collectives.sparse_allreduce(g_c, c)
            v_p, i_p = collectives.sparse_allreduce(g_pos, o)
            v_n, i_n = collectives.sparse_allreduce(g_neg.reshape(-1, DIM), n.reshape(-1))
            emb.index_add_(0, i_c, v_c, alpha=-lr)
            ctx.index_add_(0, i_p, v_p, alpha=-lr)
            ctx.index_add_(0, i_n, v_n, alpha=-lr)
            losses.append(hvd.metric_average(loss.item()))
        if rank == 0:
            print(f"epoch {epoch + 1} loss {np.mean(losses):.4f} "
                  f"(sparse rows/step: {BATCH * size * (2 + NEG)})", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()
