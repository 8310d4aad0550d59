"""The paired-end path on the card equals the same path on the CPU: the
fused two-mate step's tables (which run the CUDA SW kernel on the card
and its plain version on the CPU) and the PE SAM text. Skips without a
CUDA device. Imports no jax, so it runs on a card machine without it:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_paired_cuda.py``."""

import numpy as np
import pytest
import torch

from bioseqdb_tpu_torch.align.options import AlignOptions
from bioseqdb_tpu_torch.align.pipeline import Aligner
from bioseqdb_tpu_torch.index.builder import build_index
from bioseqdb_tpu_torch.io.batch import pack_reads
from bioseqdb_tpu_torch.kernels import build
from bioseqdb_tpu_torch.sam.emit import emit_sam_pair_columns
from bioseqdb_tpu_torch.utils.sim import simulate_genome, simulate_pairs

pytestmark = pytest.mark.cuda


def test_pairs_cuda_equal_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = simulate_genome(80_000, seed=73)
    idx = build_index([("g", g)])
    r1, r2, _ = simulate_pairs(g, 96, read_len=150, insert_mean=400,
                               insert_std=40, sub_rate=0.01, seed=74)
    # mates of different widths: every fourth R2 trimmed, R2 packed at 152
    reads2 = [s[:120] if i % 4 == 0 else s for i, s in enumerate(r2.reads)]
    b1 = pack_reads(r1.reads, r1.names)
    b2 = pack_reads(reads2, r2.names, pad_width_to=8)
    res = {}
    for dev in ("cuda", "cpu"):
        al = Aligner.build(idx, AlignOptions(), device=dev)
        n0 = build.LAUNCHES["sw_extend"]
        out = al.device_regions_pair(b1, b2)
        launched = build.LAUNCHES["sw_extend"] - n0
        cols = al.align_pairs_columns(b1, b2)
        res[dev] = (out, launched,
                    emit_sam_pair_columns(*cols, idx, b1, b2, header=False))
    assert res["cuda"][1] > 0 and res["cpu"][1] == 0
    for card, cpu in zip(res["cuda"][0], res["cpu"][0]):
        for k in ("n_regs", "overflow", "l_rep", "off"):
            assert np.array_equal(card[k], cpu[k]), k
        for k, v in cpu["regs"].items():
            assert card["regs"][k].dtype == v.dtype
            assert np.array_equal(card["regs"][k], v), k
    assert res["cuda"][2] == res["cpu"][2]
    assert res["cuda"][2].count("\t99\t") >= 80     # proper FR pairs, R1
