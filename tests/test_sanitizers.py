"""Sanitizer / debug lanes (SURVEY §5 row 2).

Two lanes the reference never had:
  * ASan+UBSan build of the native engine (native/Makefile `asan` target),
    exercised in a subprocess with the runtime LD_PRELOADed — catches
    out-of-bounds, use-after-free, and UB in the C ABI pointer plumbing.
  * jax.experimental.checkify over the device scoring path — catches
    out-of-bounds gathers/scatters and division errors inside jit, which
    silently clamp on an accelerator in normal execution.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(REPO, "native")


def _find_asan_runtime() -> str | None:
    try:
        out = subprocess.run(
            ["ldconfig", "-p"], capture_output=True, text=True, check=True
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    for line in out.splitlines():
        if "libasan.so" in line and "=>" in line:
            return line.split("=>")[1].strip()
    return None


class TestNativeASan:
    def test_engine_under_asan_ubsan(self):
        asan_rt = _find_asan_runtime()
        if asan_rt is None:
            pytest.skip("libasan runtime not found")
        r = subprocess.run(["make", "-C", NATIVE_DIR, "asan", "-s"],
                           capture_output=True, text=True)
        if r.returncode != 0:
            pytest.skip(f"asan build failed: {r.stderr[-200:]}")

        # subprocess: ASan must be loaded before python; run the threaded
        # merge through the instrumented engine and compare against the spec
        script = textwrap.dedent("""
            import sys
            sys.path.insert(0, %r)
            from genomeassembler_dev.merge import native
            from genomeassembler_dev.spec import reference_semantics as spec
            assert native.available(), "instrumented engine failed to load"

            contigs = ["ACGTACGTAC", "GTACGGGTTT", "TTTACGTACG", "CCCCACGTAC"]
            got = native.assemble_native(contigs, 5, 1234, 500, 2)
            orderings = spec.shuffled_orderings(contigs, 1234, 500)
            want = spec.assemble_solutions(orderings, 5)
            assert got == want, (got[:3], want[:3])
            print("ASAN_LANE_OK")
        """ % REPO)
        env = dict(os.environ)
        env.update({
            "GADEV_SO": os.path.join(NATIVE_DIR, "libgadev_asan.so"),
            "LD_PRELOAD": asan_rt,
            # leak checking off: python itself reports thousands of spurious
            # leaks at exit; the lane targets memory errors and UB
            "ASAN_OPTIONS": "detect_leaks=0,abort_on_error=1",
            "UBSAN_OPTIONS": "halt_on_error=1",
        })
        r = subprocess.run([sys.executable, "-c", script], env=env,
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0 and "ASan runtime does not come first" in r.stderr:
            pytest.skip("ASan preload rejected in this environment")
        assert r.returncode == 0, r.stderr[-2000:]
        assert "ASAN_LANE_OK" in r.stdout


class TestCheckifyLane:
    def test_breakscore_checkified(self):
        """Index/div checks over the device scorer: a silently clamped
        gather would surface here as a checkify error."""
        from jax.experimental import checkify

        from genomeassembler_dev.core.encoding import encode_dna
        from genomeassembler_dev.core.querytable import (
            load_default_query_table)
        from genomeassembler_dev.pipeline.assembler import (
            pack_strings, pad_reads)
        from genomeassembler_dev.score.breakscore import breakscore
        from genomeassembler_dev.sim.reads import dedup_reads
        from genomeassembler_dev.sim.segments import synthetic_genome

        table = load_default_query_table()
        g = synthetic_genome(3, 200)
        paths = [g, g[:150], g[50:]]
        reads = [g[i : i + 12] for i in range(0, 180, 7)]
        pmat, plens = pack_strings(paths, s_multiple=8, l_multiple=128)
        codes = np.stack([encode_dna(r) for r in reads])
        uniq, counts = dedup_reads(codes, np.ones(len(reads), bool))
        rcodes, rcounts, rvalid = pad_reads(uniq, counts, 128)

        def run(pm, pl, rc, rn, rv, probs):
            return breakscore(pm, pl, rc, rn, rv, probs, break_kmer=8,
                              read_chunk=128)

        checked = checkify.checkify(
            run, errors=checkify.index_checks | checkify.div_checks
        )
        err, bs = jax.jit(checked)(
            jnp.asarray(pmat), jnp.asarray(plens), jnp.asarray(rcodes),
            jnp.asarray(rcounts), jnp.asarray(rvalid),
            jnp.asarray(table.combined, jnp.float32),
        )
        err.throw()  # no OOB gathers / scatters / zero-divides
        assert np.asarray(bs.bp_score).shape[0] == pmat.shape[0]

    def test_dbg_walk_checkified(self):
        """div_checks only: the dense walk deliberately routes masked lanes
        to out-of-range drop sentinels (scatter mode='drop' .set writes,
        dbg/dense.py:185-209), which index_checks would flag by design."""
        from jax.experimental import checkify

        from genomeassembler_dev.dbg.dense import contigs_dense
        from genomeassembler_dev.ops.windows import kmer_window_codes
        from genomeassembler_dev.core.encoding import encode_dna
        from genomeassembler_dev.sim.segments import synthetic_genome

        g = synthetic_genome(4, 150)
        reads = np.stack([encode_dna(g[i : i + 12]) for i in range(0, 138, 3)])
        kc, kv = kmer_window_codes(jnp.asarray(reads), 9)

        def run(kc, kv):
            return contigs_dense(kc, kv, 9, 300, 256)

        checked = checkify.checkify(run, errors=checkify.div_checks)
        err, out = jax.jit(checked)(kc, kv)
        err.throw()
        assert int(out[4]) > 0  # some walks produced
