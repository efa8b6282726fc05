"""The wave Huffman decoder as a Pallas kernel on the Triton route (GPU).

Same decode as the plain ``jnp`` wave (``ops/device_entropy.py``), laid out
for a SIMT machine instead of vector registers:

- one lane (a restart segment, real or virtual) per thread, ``LANE_BLOCK``
  lanes per program; all lane state (64-bit bit window, word cursor, MCU
  position, block slot, coefficient index, DC predictors, error) lives in
  registers inside one in-kernel ``while_loop`` whose condition is "any lane
  of this block still active", so blocks finish independently;
- the bitstream is read straight from the dense word stream at
  ``word_off[lane] + wcur`` (no lane-major copy of the words);
- Huffman tables (``lentab``/``values``, banked per image) and the zigzag
  order are per-lane gathers from small tables that stay in L1;
- each decoded coefficient is a masked int16 store straight into the
  zero-initialised natural-order coefficient tensor. Lanes own disjoint
  blocks, so there are no emission buffers and no scatter pass.

The output carries ``LANE_BLOCK`` spare entries past the coefficients: lanes
that do not write this step aim their (masked-off) store at a slot of their
own there, which keeps the interpreter's gather/scatter emulation of masked
stores free of duplicate indices. Consumers slice the tail away
(``device_entropy.unflatten_coefficients``).

Reference context: this is the symbol automaton of ITU-T T.81 Annex F that
rocJPEG hands to the VCN ASIC (src/rocjpeg_vaapi_decoder.cpp); lanes are
restart segments as the reference forwards them in
slice_parameter_buffer.restart_interval (src/rocjpeg_parser.cpp:374-390).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core.zigzag import ZIGZAG_ORDER

# Lanes per program (one per thread: LANE_BLOCK == 32 * NUM_WARPS).
LANE_BLOCK = 128
NUM_WARPS = 4
# Symbols decoded per loop iteration (amortises the block-wide "any lane
# active" reduction of the loop condition). max_steps is a multiple of 256.
UNROLL = 2


def _select(idx, table):
    """table[idx] for a short static python table (a select chain)."""
    out = jnp.full(idx.shape, table[0], jnp.int32)
    for s in range(1, len(table)):
        out = jnp.where(idx == s, jnp.int32(table[s]), out)
    return out


@functools.lru_cache(maxsize=64)
def build_wave_kernel(geom, n_lanes: int, n_words: int, max_steps: int,
                      n_banks: int = 1, interpret: bool = False):
    """The wave kernel for one static geometry (un-jitted, so the mesh layer
    can wrap it in ``shard_map``):

    fn(dense (W,) u32, word_off (L,) i32, img_base (L,) i32,
       mcu_start (L,) i32, mcu_count (L,) i32, lentab (4*n_banks, 16) u32,
       values (n_banks*89,) u32 [, bank (L,) i32 when n_banks > 1])
      -> (coeffs int16 (B*total_blocks*64 + LANE_BLOCK,), err bool (L,))

    Lane l reads word j of its segment at dense[word_off[l] + j] for
    j < n_words, and zero past that, exactly as the ``jnp`` wave sees it.
    ``interpret`` runs the kernel under the Pallas interpreter (tests)."""
    from ..ops.device_entropy import _VAL_OFFS, _VAL_TOTAL, _VAL_WORDS

    if n_lanes % LANE_BLOCK:
        raise ValueError(f"n_lanes {n_lanes} is not a multiple of "
                         f"{LANE_BLOCK}")
    if max_steps % UNROLL:
        raise ValueError(f"max_steps {max_steps} is not a multiple of "
                         f"{UNROLL}")
    nslots = len(geom.flat_off)
    ncomp = geom.ncomp
    out_size = geom.batch * geom.total_blocks * 64
    mcus_w = geom.mcus_w
    comp_slots = [[s for s in range(nslots) if geom.comp_of_slot[s] == c]
                  for c in range(ncomp)]

    def kernel(dense_ref, word_off_ref, img_base_ref, mx0_ref, my0_ref,
               mcu_count_ref, lentab_ref, values_ref, zigzag_ref, *rest):
        if n_banks > 1:
            bank_ref, _zeros_ref, out_ref, err_ref = rest
            bank = bank_ref[...]
            bank4 = bank * 4
            bank_words = bank * _VAL_WORDS
        else:
            _zeros_ref, out_ref, err_ref = rest
        word_off = word_off_ref[...]
        img_base = img_base_ref[...]
        dump = out_size + jax.lax.broadcasted_iota(
            jnp.int32, (LANE_BLOCK,), 0)
        zero_u = jnp.zeros((LANE_BLOCK,), jnp.uint32)

        def one_symbol(st):
            acc0, acc1, navail, wcur, mx, my, mcu_rem, slot, k, dc, err = st
            active = (mcu_rem > 0) & (err == 0)

            # ---- refill: insert one 32-bit word when fewer than 33 bits
            # remain (a symbol consumes at most 16 + 15 bits). ----
            need = navail <= 32
            fetch = need & active & (wcur < n_words)
            w = plgpu.load(
                dense_ref.at[word_off + jnp.minimum(wcur, n_words - 1)],
                mask=fetch, other=0)
            na_u = (navail & 31).astype(jnp.uint32)
            hi_or = jnp.where(navail < 32, w >> na_u, zero_u)
            lo_or = jnp.where(
                navail == 0, zero_u,
                jnp.where(navail == 32, w,
                          w << ((32 - navail) & 31).astype(jnp.uint32)))
            acc0 = jnp.where(need, acc0 | hi_or, acc0)
            acc1 = jnp.where(need, acc1 | lo_or, acc1)
            navail = jnp.where(need, navail + 32, navail)
            wcur = jnp.where(need, wcur + 1, wcur)

            win = acc0
            is_dc = k == 0
            tslot = jnp.where(is_dc, _select(slot, geom.dc_slot),
                              _select(slot, geom.ac_slot))
            if n_banks > 1:
                tslot = tslot + bank4

            # ---- canonical decode: the first code length whose
            # left-aligned prefix is below that length's maxcode+1 (with no
            # match, length 1 — the lane is flagged below). ----
            row = tslot * 16
            found = jnp.zeros((LANE_BLOCK,), jnp.bool_)
            codelen = jnp.ones((LANE_BLOCK,), jnp.int32)
            code = base = None
            for li in range(16):
                ent = plgpu.load(lentab_ref.at[row + li], mask=active,
                                 other=0)
                maxc1 = (ent >> 15).astype(jnp.int32)
                b15 = (ent & 0x7FFF).astype(jnp.int32)
                cand = (win >> (31 - li)).astype(jnp.int32)
                if li == 0:
                    code, base = cand, b15
                ok = (cand < maxc1) & ~found
                codelen = jnp.where(ok, li + 1, codelen)
                code = jnp.where(ok, cand, code)
                base = jnp.where(ok, b15, base)
                found = found | ok
            sym_idx = (code + base) & 0x7FFF
            err = jnp.where(active & ~found, 1, err)

            # ---- symbol byte from the packed value table ----
            toff = _select(tslot & 3, _VAL_OFFS)
            flat_sym = jnp.clip(toff + sym_idx, 0, _VAL_TOTAL - 1)
            widx = flat_sym >> 2
            if n_banks > 1:
                widx = widx + bank_words
            vword = plgpu.load(values_ref.at[widx], mask=active, other=0)
            symbol = ((vword >> ((flat_sym & 3) << 3).astype(jnp.uint32))
                      & 0xFF).astype(jnp.int32)
            run = symbol >> 4
            size = symbol & 15

            # ---- magnitude bits right after the code ----
            ext_shift = (32 - codelen - size).astype(jnp.uint32)
            ext = ((win >> ext_shift)
                   & ((jnp.uint32(1) << size.astype(jnp.uint32)) - 1)
                   ).astype(jnp.int32)
            half = jnp.int32(1) << jnp.maximum(size - 1, 0)
            val = jnp.where(size == 0, 0,
                            jnp.where(ext < half, ext - (half << 1) + 1, ext))

            # ---- DC prediction ----
            comp_oh = []
            for c in range(ncomp):
                m = slot == comp_slots[c][0]
                for s in comp_slots[c][1:]:
                    m = m | (slot == s)
                comp_oh.append(m)
            dc_cur = jnp.zeros((LANE_BLOCK,), jnp.int32)
            for c in range(ncomp):
                dc_cur = jnp.where(comp_oh[c], dc[c], dc_cur)
            dc_new = dc_cur + val
            upd = active & is_dc
            dc = tuple(jnp.where(upd & comp_oh[c], dc_new, dc[c])
                       for c in range(ncomp))

            # ---- AC bookkeeping and the coefficient store ----
            is_eob = (~is_dc) & (size == 0) & (run != 15)
            is_zrl = (~is_dc) & (size == 0) & (run == 15)
            k_coeff = jnp.where(is_dc, 0, jnp.minimum(k + run, 63))
            overrun = (~is_dc) & (size > 0) & (k + run > 63)
            err = jnp.where(active & overrun, 1, err)
            k_nat = plgpu.load(zigzag_ref.at[k_coeff], mask=active, other=0)
            block_flat = (img_base + _select(slot, geom.flat_off)
                          + my * _select(slot, geom.row_step)
                          + mx * _select(slot, geom.col_step))
            coeff_idx = block_flat * 64 + k_nat
            writes = (active & (is_dc | ((size > 0) & ~overrun))
                      & (coeff_idx >= 0) & (coeff_idx < out_size))
            write_val = jnp.where(is_dc, dc_new, val).astype(jnp.int16)
            plgpu.store(out_ref.at[jnp.where(writes, coeff_idx, dump)],
                        write_val, mask=writes)

            # ---- advance within block / MCU / image ----
            k_next = jnp.where(is_dc, 1,
                               jnp.where(is_eob, 64,
                                         jnp.where(is_zrl, k + 16,
                                                   k + run + 1)))
            block_done = k_next >= 64
            slot_next = jnp.where(block_done, slot + 1, slot)
            mcu_done = slot_next >= nslots
            slot_next = jnp.where(mcu_done, 0, slot_next)
            k_next = jnp.where(block_done, 0, k_next)
            mx_next = jnp.where(mcu_done, mx + 1, mx)
            row_wrap = mx_next >= mcus_w
            mx_next = jnp.where(row_wrap, 0, mx_next)
            my_next = jnp.where(row_wrap, my + 1, my)
            mcu_rem_next = jnp.where(mcu_done, mcu_rem - 1, mcu_rem)

            # ---- consume codelen + size bits ----
            n_u = (codelen + size).astype(jnp.uint32)
            acc0n = (acc0 << n_u) | ((acc1 >> 1) >> (31 - n_u))
            acc1n = acc1 << n_u
            return (jnp.where(active, acc0n, acc0),
                    jnp.where(active, acc1n, acc1),
                    jnp.where(active, navail - (codelen + size), navail),
                    wcur,
                    jnp.where(active, mx_next, mx),
                    jnp.where(active, my_next, my),
                    jnp.where(active, mcu_rem_next, mcu_rem),
                    jnp.where(active, slot_next, slot),
                    jnp.where(active, k_next, k),
                    dc, err)

        def body(carry):
            st, nstep = carry
            for _ in range(UNROLL):
                st = one_symbol(st)
            return st, nstep + UNROLL

        def cond(carry):
            st, nstep = carry
            mcu_rem, err = st[6], st[10]
            live = ((mcu_rem > 0) & (err == 0)).astype(jnp.int32)
            return (jnp.max(live) > 0) & (nstep < max_steps)

        z = jnp.zeros((LANE_BLOCK,), jnp.int32)
        init = (zero_u, zero_u, z, z, mx0_ref[...], my0_ref[...],
                mcu_count_ref[...], z, z, tuple(z for _ in range(ncomp)), z)
        st, _ = jax.lax.while_loop(cond, body, (init, jnp.int32(0)))
        # Lanes still holding MCUs after the hard symbol bound can only be
        # corrupt (a legit lane's symbol count is bounded by its bits).
        err_ref[...] = ((st[10] != 0) | (st[6] > 0)).astype(jnp.int32)

    lane = pl.BlockSpec((LANE_BLOCK,), lambda i: (i,))
    whole = pl.BlockSpec()
    in_specs = ([whole, lane, lane, lane, lane, lane, whole, whole, whole]
                + ([lane] if n_banks > 1 else []) + [whole])
    call = pl.pallas_call(
        kernel,
        grid=(n_lanes // LANE_BLOCK,),
        in_specs=in_specs,
        out_specs=[whole, lane],
        out_shape=[
            jax.ShapeDtypeStruct((out_size + LANE_BLOCK,), jnp.int16),
            jax.ShapeDtypeStruct((n_lanes,), jnp.int32),
        ],
        input_output_aliases={len(in_specs) - 1: 0},
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="wave_triton",
    )
    zigzag = np.asarray(ZIGZAG_ORDER, np.int32)

    def fn(dense, word_off, img_base, mcu_start, mcu_count, lentab, values,
           bank=None):
        mx0 = mcu_start % jnp.int32(mcus_w)
        my0 = mcu_start // jnp.int32(mcus_w)
        args = [dense, word_off, img_base, mx0, my0, mcu_count,
                lentab.reshape(-1), values.reshape(-1), jnp.asarray(zigzag)]
        if n_banks > 1:
            args.append(bank)
        args.append(jnp.zeros(out_size + LANE_BLOCK, jnp.int16))
        coeffs, err = call(*args)
        return coeffs, err != 0

    return fn
