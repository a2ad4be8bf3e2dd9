"""Shared implementation of the viterbi / posterior decoding workflows
(reference workflow_viterbi.py / workflow_posterior.py): config resolution,
model build, hidden-states CSV, decoding over the device mesh, and the
output CSV writers (formats byte-compatible with the reference)."""

from __future__ import annotations

import csv
import os

import jax.numpy as jnp
import numpy as np

from itrails_tpu.cli.common import prepare_decode_setup, resolve_io
from itrails_tpu.core.model import build_model
from itrails_tpu.data.maf import maf_reference_coordinates, maf_tokens
from itrails_tpu.data.tokens import aggregation_matrix
from itrails_tpu.hmm import decoders, sharding, windows

TOPOLOGY_MAP = {
    0: "({sp1,sp2},sp3)",
    1: "((sp1,sp2),sp3)",
    2: "((sp1,sp3),sp2)",
    3: "((sp2,sp3),sp1)",
    4: "({sp2,sp3},sp1)",  # introgressed (reference workflow_int_viterbi.py:672)
}


def decode_main(argv, description, usage, introgression, posterior):
    """Shared main() for the four decode CLIs: full per-parameter override
    flags + config-optional invocation (reference workflow_viterbi.py:19-158
    and int variants)."""
    import sys

    from itrails_tpu import __version__
    from itrails_tpu.cli import common

    parser = common.decode_parser(description, usage=usage,
                                  introgression=introgression)
    parser.add_argument("--version", action="version",
                        version=f"%(prog)s {__version__}")
    if argv is None:
        argv = sys.argv[1:]
    if not argv:
        parser.print_usage()
        sys.exit("Error: No arguments provided. Please provide either a "
                 "config file, command-line parameters, or both.")
    args = parser.parse_args(argv)
    config = common.merge_decode_overrides(args, introgression=introgression)
    # CLI flag > settings.obs_mode > standard (the int CLIs expose no
    # flag, but settings.obs_mode is read for every decode CLI, so the
    # introgression family must reject it explicitly: marginalizing the
    # int emission table over the outgroup is an unvalidated combination)
    obs_mode = (getattr(args, "obs_mode", None)
                or config.get("settings", {}).get("obs_mode")
                or "standard")
    if obs_mode not in ("standard", "new-method"):
        raise ValueError(f"settings.obs_mode must be 'standard' or "
                         f"'new-method' (got {obs_mode!r})")
    if introgression and obs_mode != "standard":
        raise ValueError(
            "obs_mode 'new-method' is not supported by the introgression "
            "decode workflows (plain family only)"
        )
    setup, v_lst, coords, output_dir, output_prefix = load_inputs(
        config, args, introgression=introgression, obs_mode=obs_mode
    )
    print("Calculating transition and emission probability matrices.")
    model, a, bfull, pi = build(setup, args.precision, obs_mode=obs_mode)
    write_hidden_states(
        os.path.join(output_dir, f"{output_prefix}.hidden_states.csv"),
        model, setup, first_interval_from_ab=posterior,
    )
    if posterior:
        print("Running posterior decoding.")
        results = run_posterior(a, bfull, pi, v_lst)
        write_posterior_csv(
            os.path.join(output_dir, f"{output_prefix}.posterior.csv"),
            results, coords,
        )
    else:
        print("Running viterbi.")
        results = run_viterbi(a, bfull, pi, v_lst)
        write_viterbi_csv(
            os.path.join(output_dir, f"{output_prefix}.viterbi.csv"),
            results, coords,
        )


def load_inputs(config, args, introgression=False, obs_mode="standard"):
    maf_path, user_output, output_dir, output_prefix = resolve_io(config, args)
    setup = prepare_decode_setup(config, introgression=introgression)
    setup["introgression"] = introgression
    species = setup["settings"]["species_list"]
    if obs_mode == "new-method":
        from itrails_tpu.data.maf import maf_tokens_new_method

        if len(species) != 3:
            raise ValueError(
                "--obs-mode new-method requires species_list to name "
                f"exactly three species (got {species})"
            )
        v_lst = maf_tokens_new_method(maf_path, species)
    else:
        v_lst = maf_tokens(maf_path, species)
    if not v_lst:
        raise ValueError("Error reading MAF alignment file.")
    ref = setup["settings"].get("reference")
    coords = (
        maf_reference_coordinates(maf_path, species, ref) if ref is not None else None
    )
    return setup, v_lst, coords, output_dir, output_prefix


def build(setup, precision="float64", obs_mode="standard"):
    d = setup["params"]
    if setup.get("introgression"):
        from itrails_tpu.introgression.builder import build_model_introgression

        model = build_model_introgression(
            d["t_A"], d["t_B"], d["t_C"], d["t_2"], d["t_upper"], d["t_out"],
            d["t_m"], d["N_AB"], d["N_BC"], d["N_ABC"], d["r"], d["m"],
            d["n_int_AB"], d["n_int_ABC"],
            cut_AB=setup["norm_cut_ab"], cut_ABC=setup["norm_cut_abc"],
        )
    else:
        model = build_model(
            d["t_A"], d["t_B"], d["t_C"], d["t_2"], d["t_upper"], d["t_out"],
            d["N_AB"], d["N_ABC"], d["r"], d["n_int_AB"], d["n_int_ABC"],
            cut_AB=setup["norm_cut_ab"], cut_ABC=setup["norm_cut_abc"],
        )
    cast = jnp.dtype(precision)
    a = model.a.astype(cast)
    pi = model.pi.astype(cast)
    if obs_mode == "new-method":
        bfull = decoders.emission_table_new_method(
            model.b.astype(cast), pad_to=625
        )
    else:
        bfull = decoders.emission_table(
            model.b.astype(cast), jnp.asarray(aggregation_matrix(), cast)
        )
    return model, a, bfull, pi


def write_hidden_states(path, model, setup, first_interval_from_ab: bool):
    """``<prefix>.hidden_states.csv`` (reference workflow_viterbi.py:636-684
    / workflow_posterior.py — the two differ in whether V0 first-coalescent
    intervals are annotated with AB or ABC cutpoints; ``first_interval_from_ab``
    selects the posterior behavior)."""
    abs_ab = setup["abs_cut_ab"]
    abs_abc = setup["abs_cut_abc"]
    if os.path.exists(path):
        print(f"Warning: File '{path}' already exists.")
        path = path.replace(".hidden_states.csv", ".hidden_states_2.csv")
        print(f"Using an alternative file name: {path}")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["state_idx", "topology", "interval_1st_coalescent",
                    "interval_2nd_coalescent", "shorthand_name"])
        for idx, state in enumerate(model.hidden_states):
            code, i, j = state
            if code == 0 and first_interval_from_ab:
                lo, hi = abs_ab[i], abs_ab[i + 1]
            else:
                lo, hi = abs_abc[i], abs_abc[i + 1]
            w.writerow([
                idx,
                TOPOLOGY_MAP.get(code, "Unknown"),
                f"{lo:.2f}-{hi:.2f}",
                f"{abs_abc[j]:.2f}-{abs_abc[j+1]:.2f}",
                tuple(state),
            ])
    print(f"Hidden states written to file {path}.")


# Blocks longer than this decode via the sequence-parallel path (the
# window-batch scan is latency-bound at 1 window; see hmm/longseq.py).
LONG_BLOCK_THRESHOLD = windows.LONG_BLOCK_THRESHOLD


def _split_by_length(v_lst):
    short = [(i, v) for i, v in enumerate(v_lst) if len(v) <= LONG_BLOCK_THRESHOLD]
    long = [(i, v) for i, v in enumerate(v_lst) if len(v) > LONG_BLOCK_THRESHOLD]
    return short, long


# Above this length the Viterbi backpointer table is streamed in bounded-
# memory segments (longseq.viterbi_segmented) instead of materialised whole.
SEGMENTED_VITERBI_THRESHOLD = 8_388_608


def run_viterbi(a, bfull, pi, v_lst):
    from itrails_tpu.hmm.longseq import viterbi_long, viterbi_segmented

    short, long = _split_by_length(v_lst)
    out = [None] * len(v_lst)
    if short:
        mesh = sharding.data_mesh()
        tokens, lengths, owner = windows.pack_windows(
            [v for _, v in short], pad_windows_to=mesh.devices.size
        )
        paths = np.asarray(
            sharding.sharded_viterbi(a, bfull, pi, jnp.asarray(tokens), mesh)
        )
        rows = [paths[w, : lengths[w]] for w in range(len(owner)) if owner[w] >= 0]
        for (i, _), row in zip(short, rows):
            out[i] = row
    if long:
        from itrails_tpu.hmm.longseq_sharded import (
            sharded_viterbi_long,
            sharded_viterbi_segmented,
        )

        mesh = sharding.data_mesh()
        for i, v in long:
            v = jnp.asarray(v, jnp.int32)
            if len(v) > SEGMENTED_VITERBI_THRESHOLD:
                if mesh.devices.size > 1:
                    out[i] = sharded_viterbi_segmented(a, bfull, pi, v, mesh)
                else:
                    out[i] = viterbi_segmented(a, bfull, pi, v)
            elif mesh.devices.size > 1:
                out[i] = sharded_viterbi_long(a, bfull, pi, v, mesh)
            else:
                out[i] = viterbi_long(a, bfull, pi, v)
    return out


def run_posterior(a, bfull, pi, v_lst):
    from itrails_tpu.hmm.longseq import posterior_long

    short, long = _split_by_length(v_lst)
    out = [None] * len(v_lst)
    if short:
        mesh = sharding.data_mesh()
        tokens, lengths, owner = windows.pack_windows(
            [v for _, v in short], pad_windows_to=mesh.devices.size
        )
        post = np.asarray(
            sharding.sharded_posterior(a, bfull, pi, jnp.asarray(tokens), mesh)
        )  # (T, W, M)
        rows = [post[: lengths[w], w, :] for w in range(len(owner)) if owner[w] >= 0]
        for (i, _), row in zip(short, rows):
            out[i] = row
    if long:
        from itrails_tpu.hmm.longseq_sharded import sharded_posterior_long

        mesh = sharding.data_mesh()
        for i, v in long:
            v = jnp.asarray(v, jnp.int32)
            if mesh.devices.size > 1:
                # one long block spans every chip of the slice
                out[i] = sharded_posterior_long(a, bfull, pi, v, mesh)
            else:
                out[i] = np.asarray(posterior_long(a, bfull, pi, v))
    return out


def _rle_rows(block_idx, res, c):
    """Rows of the Viterbi segment CSV for one block, matching the
    reference's per-position serial loop (workflow_viterbi.py:692-744)
    exactly — but touching Python only at *state-change events* (found
    vectorized with np.diff), so a chromosome-scale block costs O(#segments)
    instead of O(T)."""
    res = np.asarray(res)
    n = len(res)
    rows = []
    if n == 0:
        return rows
    if c is None:
        bounds = np.flatnonzero(res[1:] != res[:-1]) + 1  # segment starts
        starts = np.concatenate([[0], bounds])
        ends = np.concatenate([bounds - 1, [n - 1]])
        for s, e in zip(starts, ends):
            rows.append([block_idx, s, e, res[s]])
        return rows

    # Event-driven replay of the reference's per-position state machine.
    # Serial semantics: a change at a non-gap position ends the segment and
    # starts a new one there; a change at a GAP position ends the segment
    # and enters "reset" mode, in which all further changes are swallowed
    # until the next non-gap position restarts a segment; a block ending in
    # reset mode emits no final row.  Within a segment `res` is constant,
    # so the only positions that matter are the change events (np.diff) and
    # the anchors (c != -9) bracketing them.
    c = np.asarray(c)
    anchor_idx = np.flatnonzero(c != -9)
    if anchor_idx.size == 0:
        return rows
    first = int(anchor_idx[0])
    # index of the last anchor strictly before each event / end
    events = np.flatnonzero(res[first + 1:] != res[first:-1]) + first + 1
    lb_at = anchor_idx[
        np.maximum(np.searchsorted(anchor_idx, events, side="left") - 1, 0)
    ] if events.size else np.empty(0, np.int64)
    next_anchor_at = np.searchsorted(anchor_idx, events, side="right")

    seg_start = int(c[first])
    cur = res[first]
    reset_exit = -1  # >=0: in reset mode until the anchor at this index
    for k in range(len(events)):
        p = int(events[k])
        if reset_exit >= 0:
            if p <= reset_exit:
                continue  # swallowed inside the gap (or at the exit anchor)
            # a new segment began at the exit anchor
            seg_start = int(c[reset_exit])
            cur = res[reset_exit]
            reset_exit = -1
            if res[p] == cur:
                continue  # no change relative to the restarted segment
        cur_non_null = int(c[lb_at[k]])
        rows.append([block_idx, seg_start, cur_non_null, cur])
        if c[p] != -9:
            seg_start = int(c[p])
            cur = res[p]
        else:
            j = next_anchor_at[k]
            if j < anchor_idx.size:
                reset_exit = int(anchor_idx[j])
            elif p == n - 1:
                # change at the final position, gap coordinate: the serial
                # loop ends before any reset iteration clears cur_non_null,
                # so a (-9)-start row IS emitted
                rows.append([block_idx, -9, int(c[anchor_idx[-1]]), res[p]])
                return rows
            else:
                return rows  # terminal gap run: reference emits nothing more
    if reset_exit >= 0:
        seg_start = int(c[reset_exit])
        cur = res[reset_exit]
    rows.append([block_idx, seg_start, int(c[anchor_idx[-1]]), cur])
    return rows


def write_viterbi_csv(path, results, coords):
    """Run-length-encoded state segments (reference
    workflow_viterbi.py:692-744).  Event-driven RLE: np.diff finds the
    segment boundaries so writing a 1e8-column block is O(#segments)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Block_idx", "position_start", "position_end",
                    "most_likely_state"])
        for block_idx, res in enumerate(results):
            c = None if coords is None else coords[block_idx]
            w.writerows(_rle_rows(block_idx, res, c))
    print(f"Viterbi decoding complete. Results saved to {path}.")


def write_posterior_csv(path, results, coords):
    """Per-position per-state probabilities (reference
    workflow_posterior.py:697-716): the reference's csv.writer text
    (shortest round-trip float repr after the f64 widening), written in
    chunks so a 1e8-row posterior streams through bounded memory."""
    chunk_rows = 1 << 18
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        n_states = results[0].shape[1] if results else 0
        w.writerow(["alignment_block_idx", "position_idx"]
                   + [f"prob_state_{i}" for i in range(n_states)])
        for block_idx, arr in enumerate(results):
            arr = np.asarray(arr, np.float64)
            pos = (np.arange(len(arr), dtype=np.int64) if coords is None
                   else np.asarray(coords[block_idx], np.int64))
            for off in range(0, len(arr), chunk_rows):
                chunk = arr[off:off + chunk_rows]
                pc = pos[off:off + chunk_rows]
                f.write("\n".join(
                    f"{block_idx},{p}," + ",".join(map(repr, row))
                    for p, row in zip(pc.tolist(), chunk.tolist())
                ) + "\n")
    print(f"Posterior decoding complete. Results saved to {path}.")
