"""PyTorch port vs JAX package: the slot sort.

sort_slots_aux_reference (the plain version of csrc/sort_slots.cu) against
trace_kernel._sort_slots in the inline Pallas kernel of
tests/test_pallas_kernel.py (interpret mode), on that test's inputs: K 16,
5 auxiliary blocks, exact depth ties (t[:, 3] = t[:, 5]) and empty
(3e38) slots in front and interleaved.  _sort_slots orders by (t, slot
index), the port by (t, id), so the rule is: t equal everywhere; ids and
auxiliary values equal outside groups of equal t; within each such group,
the (id, aux) columns a permutation of JAX's.  Exact comparisons: a sort
moves values and rounds nothing.

The kernel itself runs only on a CUDA card:
test_torch_sort_dtype_cuda.py compares it with this plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from editable_gaussian_reflections_tpu.ops.pallas.trace_kernel import (
    AUX_GEO,
    _sort_slots,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.sort_slots import (
    sort_slots_aux,
    sort_slots_aux_reference,
)

R, K = 8, 16


def _inputs(seed, id_ties):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, 10, (R, K)).astype(np.float32)
    t[:, 3] = t[:, 5]          # exact ties
    t[0, :4] = 3.0e38          # empty slots mixed in front
    t[1, ::2] = 3.0e38
    ids = rng.integers(0, 1000, (R, K)).astype(np.float32)
    if id_ties:
        ids[:, 3] = ids[:, 5]  # equal (t, id): the stable order decides
    aux = rng.normal(size=(R, AUX_GEO * K)).astype(np.float32)
    return t, ids, aux


def _jax_sort(t, ids, aux):
    def kernel(t_ref, id_ref, aux_ref, to_ref, ido_ref, auxo_ref):
        to_ref[:] = t_ref[:]
        ido_ref[:] = id_ref[:]
        auxo_ref[:] = aux_ref[:]
        _sort_slots(to_ref, ido_ref, auxo_ref, K, A=AUX_GEO)

    out = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((R, K), jnp.float32),
                   jax.ShapeDtypeStruct((R, K), jnp.float32),
                   jax.ShapeDtypeStruct((R, AUX_GEO * K), jnp.float32)),
        interpret=True,
    )(jnp.asarray(t), jnp.asarray(ids), jnp.asarray(aux))
    return tuple(np.asarray(x) for x in out)


def _columns(ids, aux, r, cols):
    """The (id, aux blocks) tuples of ray r's slots `cols`, sorted."""
    blocks = aux[r].reshape(AUX_GEO, K)
    return sorted((float(ids[r, c]), *blocks[:, c].tolist()) for c in cols)


@pytest.mark.parametrize("id_ties", [False, True])
def test_reference_matches_pallas_up_to_tie_order(id_ties):
    t, ids, aux = _inputs(7, id_ties)
    jt, jids, jaux = _jax_sort(t, ids, aux)
    st, sid, saux = (x.numpy() for x in sort_slots_aux_reference(
        torch.tensor(t), torch.tensor(ids.astype(np.int32)),
        torch.tensor(aux)))
    np.testing.assert_array_equal(st, jt)
    n_tied = 0
    for r in range(R):
        _vals, start, count = np.unique(st[r], return_index=True,
                                        return_counts=True)
        for s0, n in zip(start, count):
            cols = range(s0, s0 + n)
            assert (_columns(sid.astype(np.float32), saux, r, cols)
                    == _columns(jids, jaux, r, cols))
            n_tied += n > 1
        single = np.repeat(count == 1, count)
        np.testing.assert_array_equal(sid[r][single], jids[r][single])
        blocks = saux[r].reshape(AUX_GEO, K)[:, single]
        np.testing.assert_array_equal(
            blocks, jaux[r].reshape(AUX_GEO, K)[:, single])
    assert n_tied >= R  # every ray has the t[:, 3] = t[:, 5] tie
    # the port's order within a tie: by id
    tie = st[:, 1:] == st[:, :-1]
    assert (sid[:, 1:][tie] >= sid[:, :-1][tie]).all()


def test_wrapper_takes_plain_version_for_cpu_tensors():
    t, ids, aux = (torch.tensor(x) for x in _inputs(3, False))
    ids = ids.to(torch.int32)
    before = sort_slots_aux.launches
    for a, b in zip(sort_slots_aux(t, ids, aux),
                    sort_slots_aux_reference(t, ids, aux)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert sort_slots_aux.launches == before
