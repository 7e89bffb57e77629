"""Paged single-token GQA decode attention: the Hopper kernel and its
wrapper.

The kernel is ``csrc/paged_decode.cu`` (it replaces the TPU kernel
``repro/kernels/flash_decode.py::paged_flash_decode_attention``); the
plain version is ``ref.paged_flash_decode_attention``. A CPU tensor takes
the plain version; a CUDA tensor launches the kernel or raises. The
contiguous-cache kernel of the same JAX module is not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

MAX_HEAD_DIM = 256


def paged_flash_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 page_table: torch.Tensor, *,
                                 kv_len: torch.Tensor | None = None,
                                 sm_scale: float | None = None):
    """Decode attention over a paged KV pool.

    q: ``[batch, q_heads, head_dim]``; k_pages, v_pages: ``[num_pages,
    page_size, kv_heads, head_dim]``; page_table: ``[batch, pages_per_seq]``
    int32 (logical page ``j`` of request ``b`` is physical page
    ``page_table[b, j]``); kv_len: ``[batch]`` valid lengths (default: the
    whole table). Returns ``[batch, q_heads, head_dim]`` in q's dtype.
    Table entries at or past ``kv_len`` may point anywhere (the engine
    points them at its trap page): they are masked and never read.
    """
    if q.device.type == "cpu":
        return ref.paged_flash_decode_attention(
            q, k_pages, v_pages, page_table, kv_len=kv_len,
            sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode_attention runs on cpu or "
                         f"cuda, not {q.device}")
    b, hq, dh = q.shape
    n_pages, page, hkv, dh_k = k_pages.shape
    n_pt = page_table.shape[1]
    if v_pages.shape != k_pages.shape or dh_k != dh:
        raise ValueError(f"pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"q_heads {hq} is not a multiple of kv_heads {hkv}")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {dh} > {MAX_HEAD_DIM}")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise ValueError("q and the pools must share one dtype")
    if page_table.shape[0] != b or page_table.dtype != torch.int32:
        raise ValueError("page_table must be int32 [batch, pages_per_seq]")
    if kv_len is None:
        kv_len = torch.full((b,), n_pt * page, dtype=torch.int32,
                            device=q.device)
    if kv_len.shape != (b,) or kv_len.dtype != torch.int32:
        raise ValueError("kv_len must be int32 [batch]")
    tensors = (q, k_pages, v_pages, page_table, kv_len)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must share one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_flash_decode_attention needs contiguous "
                         "inputs")
    if sm_scale is None:
        sm_scale = 1.0 / (dh ** 0.5)
    out = torch.empty_like(q)
    if b == 0:
        return out
    vec = _build.vector_width(dh, k_pages, v_pages)
    lib = _build.library()
    code = lib.repro_paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(), b, hq,
        hkv, dh, page, n_pt, n_pages, float(sm_scale), _build.dtype_code(q),
        vec, _build.stream_ptr(q.device))
    _build.check(lib, code, "paged_flash_decode_attention")
    paged_flash_decode_attention.launches += 1
    return out


paged_flash_decode_attention.launches = 0
