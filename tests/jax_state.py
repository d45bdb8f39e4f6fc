"""The JAX engine's resident state carried over to the port's layouts, for
the tests that hold the two equal byte for byte
(``test_torch_prep.py``, ``test_torch_big.py``)."""
import types

import numpy as np
import torch


def state_from_jax(q_packed, dsz, refbuf_p, win, nrs, device, big=None):
    """Numpy copies of ``PallasAll2All.Q`` / ``.DSZ`` (one device's
    entries) and ``PallasGroupIndex.refbuf_p`` / ``.win`` / ``.nrs`` as
    tensors on `device` under the names of the port's ``CudaAll2All.Q`` /
    ``.DSZ`` and ``GroupIndex`` (same layouts).

    `big`, when given, is a list of ``PallasAll2All.build_big_index``
    results as numpy arrays, one per reference: dicts with ``refbuf``
    (1, LrP) int32, ``khi`` / ``klo`` (LrP,) int32 sorted key words,
    ``pos`` (1, KaP) int32, ``win`` (1, WinP) int32 (its ``gidx.win``)
    and ``nr``. They become, under ``"big"``, the tensors of one
    ``BigIndex`` of those references, which the long-genome route's
    dispatch reads (``refbuf``, ``keys``, ``poslist``, ``win``, ``nrs``):
    the key is ``khi << 30 | klo`` (the JAX join's invalid entry, khi =
    2^30 and klo = 0, is the port's KEY_INVALID)."""
    dev = torch.device(device)

    def put(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)

    state = {"Q": put(q_packed, np.uint8), "DSZ": put(dsz, np.int32),
             "refbuf_p": put(refbuf_p, np.uint8), "win": put(win, np.int32),
             "nrs": put(nrs, np.int32)}
    if big:
        keys = np.stack([(np.asarray(d["khi"], np.int64) << 30)
                         | np.asarray(d["klo"], np.int64) for d in big])
        state["big"] = types.SimpleNamespace(
            refbuf=put(np.concatenate([d["refbuf"] for d in big]), np.uint8),
            keys=put(keys, np.int64),
            poslist=put(np.concatenate([d["pos"] for d in big]), np.int32),
            win=put(np.concatenate([d["win"] for d in big]), np.int32),
            nrs=put([d["nr"] for d in big], np.int32))
    return state
