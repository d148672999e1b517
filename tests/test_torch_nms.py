"""The packed-word NMS walk of ``csrc/nms_greedy.cu``, modelled in numpy.

The CUDA kernels pack the suppression matrix's strict upper triangle into
32-bit words and walk them word by word: the lowest alive bit of a word is
kept, its row clears the boxes it suppresses.  This file holds a numpy model
of that walk (the same words, the same order of steps) and requires it to be
bit-equal to the plain version ``nms_keep_reference`` and to the JAX
package's ``nms_fixed`` on the CPU: on seeded matrices and boxes, on an
adversarial chain where each box suppresses only the next, and at n = 1,
31, 33, 1000 and 1025 (a word's edge, one word, past 32 words).  Exact
comparisons: the greedy keep set is unique.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from peanut_tpu.models import boxes as jboxes
from peanut_tpu_torch.kernels.nms import nms_keep, nms_keep_reference

torch.set_num_threads(1)


def pack(sup: np.ndarray) -> np.ndarray:
    """(n, n) bool -> (n, ceil(n / 32)) uint32: bit c of word w of row j is
    sup[j, 32 w + c] for 32 w + c > j (nms_pack)."""
    n = sup.shape[-1]
    nw = -(-n // 32)
    upper = np.triu(sup.astype(bool), 1)
    padded = np.zeros((n, nw * 32), bool)
    padded[:, :n] = upper
    weights = (np.uint64(1) << np.arange(32, dtype=np.uint64))
    return (padded.reshape(n, nw, 32).astype(np.uint64)
            * weights).sum(-1).astype(np.uint32)


def packed_walk(sup: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """nms_walk: word by word, the lowest alive bit is kept; its row's word
    clears the later boxes of the word, its later words the alive words
    right of it."""
    n = sup.shape[-1]
    bits = pack(sup)
    nw = bits.shape[1]
    v = np.zeros(nw * 32, bool)
    v[:n] = valid
    weights = (np.uint64(1) << np.arange(32, dtype=np.uint64))
    alive = (v.reshape(nw, 32).astype(np.uint64) * weights).sum(-1)
    alive = alive.astype(np.uint32)
    for w in range(nw):
        aw = int(alive[w])
        todo = aw
        while todo:
            b = (todo & -todo).bit_length() - 1
            row = bits[32 * w + b]
            rw = int(row[w])
            todo &= todo - 1
            todo &= ~rw
            aw &= ~rw
            alive[w + 1:] &= ~row[w + 1:]
        alive[w] = aw
    keep = (alive[:, None] >> np.arange(32, dtype=np.uint32)) & 1
    return keep.reshape(-1)[:n].astype(bool)


def _random_case(seed, n, density):
    rng = np.random.RandomState(seed)
    sup = np.triu(rng.rand(n, n) < density, 1)
    # noise below the diagonal, which neither side may read
    sup |= np.tril(rng.rand(n, n) < 0.5, 0)
    valid = rng.rand(n) > 0.1
    return sup, valid


def _chain(n):
    sup = np.zeros((n, n), bool)
    idx = np.arange(n - 1)
    sup[idx, idx + 1] = True
    return sup


@pytest.mark.parametrize("n", [1, 31, 33, 1000, 1025])
@pytest.mark.parametrize("density", [0.003, 0.05])
def test_packed_walk_equals_plain_version(n, density):
    sup, valid = _random_case(n, n, density)
    want = nms_keep_reference(torch.as_tensor(np.triu(sup, 1)),
                              torch.as_tensor(valid)).numpy()
    np.testing.assert_array_equal(packed_walk(sup, valid), want)


@pytest.mark.parametrize("n", [1, 31, 33, 1000, 1025])
def test_packed_walk_on_a_suppression_chain(n):
    """Each box suppresses only the next: every other box is kept, and
    the plain version needs n / 2 bounding rounds."""
    sup = _chain(n)
    valid = np.ones(n, bool)
    got = packed_walk(sup, valid)
    np.testing.assert_array_equal(got, np.arange(n) % 2 == 0)
    want = nms_keep_reference(torch.as_tensor(sup),
                              torch.as_tensor(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    # the chain broken by an invalid box restarts it
    valid[n // 2] = False
    want = nms_keep_reference(torch.as_tensor(sup),
                              torch.as_tensor(valid)).numpy()
    np.testing.assert_array_equal(packed_walk(sup, valid), want)


@pytest.mark.parametrize("n", [1, 31, 33, 1000, 1025])
def test_packed_walk_equals_jax_nms_fixed(n):
    """On seeded boxes with tied and -inf scores: the JAX package's keep
    set, from the suppression matrix that its own nms_fixed builds."""
    rng = np.random.RandomState(100 + n)
    xy = rng.rand(n, 2).astype(np.float32) * 300
    wh = rng.rand(n, 2).astype(np.float32) * 120 + 2
    boxes = np.concatenate([xy, xy + wh], -1)
    scores = np.round(rng.rand(n).astype(np.float32) * 16) / 16
    scores[rng.rand(n) < 0.05] = -np.inf
    want = np.isfinite(np.asarray(jboxes.nms_fixed(
        jnp.asarray(boxes), jnp.asarray(scores), 0.5)))
    order = np.asarray(jnp.argsort(-jnp.asarray(scores)))
    b = jnp.asarray(boxes[order])
    iou = np.asarray(jboxes.pairwise_iou(b, b))
    kept = packed_walk(np.triu(iou > 0.5, 1), np.isfinite(scores[order]))
    keep = np.zeros(n, bool)
    keep[order] = kept
    np.testing.assert_array_equal(keep, want)


def test_nms_keep_on_the_cpu_is_the_plain_version():
    """The wrapper takes its plain version for a CPU tensor (the kernels
    launch only for CUDA tensors), with every leading shape."""
    sup, valid = _random_case(5, 70, 0.1)
    sup = np.triu(sup, 1)
    before = nms_keep.launches
    got = nms_keep(torch.as_tensor(np.stack([sup, sup])),
                   torch.as_tensor(np.stack([valid, ~valid])))
    assert nms_keep.launches == before
    np.testing.assert_array_equal(got[0].numpy(), packed_walk(sup, valid))
    np.testing.assert_array_equal(got[1].numpy(), packed_walk(sup, ~valid))
