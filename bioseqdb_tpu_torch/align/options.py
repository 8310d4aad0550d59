"""Alignment options — parameter-compatible with the reference's bwa_options.

Field names and defaults mirror the SQL composite + defaults factory
(reference: bioseqdb--0.0.0.sql:160-194) and the option application in
extension.cpp:220-231, which in turn populate libbwa's ``mem_opt_t``.
The one computed default, ``max_occ = max(500, 2 * n_refs)``
(extension.cpp:220), is resolved at index-bind time via
``resolve_max_occ``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AlignOptions:
    min_seed_len: int = 19       # minimum SMEM length to seed
    max_occ: int | None = None   # skip seeds with more hits; None -> max(500, 2*n_refs)
    match_score: int = 1         # mem_opt_t.a
    mismatch_penalty: int = 4    # mem_opt_t.b
    pen_clip3: int = 5
    pen_clip5: int = 5
    zdrop: int = 100
    bandwidth: int = 100         # mem_opt_t.w
    o_del: int = 6
    e_del: int = 1
    o_ins: int = 6
    e_ins: int = 1

    # engine knobs (no reference analogue; defaults follow bwa-mem's
    # mem_opt_init values where one exists)
    min_score: int = 30          # mem_opt_t.T: minimum score to report
    reseed_factor: float = 1.5   # mem_opt_t.split_factor: re-seed long MEMs
    split_width: int = 10        # mem_opt_t.split_width
    max_mem_intv: int = 20       # 3rd-round seeding interval threshold
    max_chain_gap: int = 10000   # mem_opt_t.max_chain_gap
    chain_drop_ratio: float = 0.5  # mem_opt_t.drop_ratio
    min_chain_weight: int = 0
    mask_level: float = 0.5
    mask_level_redun: float = 0.95
    xa_drop_ratio: float = 0.8   # mem_opt_t.XA_drop_ratio
    max_xa_hits: int = 5         # mem_opt_t.max_XA_hits
    max_matesw: int = 50
    pen_unpaired: int = 17       # mem_opt_t.pen_unpaired

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            if isinstance(v, (int, float)) and v < 0:
                # reference: get_opt_or rejects negatives (extension.cpp:197-209)
                raise ValueError(f"bwa_opt {f.name} must be nonnegative")

    def resolve_max_occ(self, n_refs: int) -> int:
        if self.max_occ is not None:
            return self.max_occ
        return max(500, 2 * n_refs)


def bwa_opts(**kwargs) -> AlignOptions:
    """Defaults factory mirroring SQL ``bwa_opts()`` (bioseqdb--0.0.0.sql:176)."""
    return AlignOptions(**kwargs)
