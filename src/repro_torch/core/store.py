"""Distributed tuple store: records + per-protocol metadata (port of
``repro.core.store``, paper Fig. 3).

Global key k lives on node k // records_per_node.  Layouts per protocol:

  NOWAIT   | lock(2w)            | record |
  WAITDIE  | tts=lock(2w)        | record |
  OCC      | lock(2w) | seq(1w)  | record |
  MVCC     | tts(2w) | rts(2w) | wts[4](8w) | record[4] |
  SUNDIAL  | lock(2w) | rts(2w) | wts(2w) | record |

``ver`` is a protocol-independent commit-version counter read only by the
serializability validator.
"""
from __future__ import annotations

from typing import Dict

import torch

N_VERSIONS = 4  # MVCC static version slots (paper §4.4: four)


def init_store(
    protocol: str,
    n_records: int,
    rw: int,
    init_value: int = 0,
    n_versions: int = N_VERSIONS,
    *,
    device,
) -> Dict[str, torch.Tensor]:
    def z(*s):
        return torch.zeros(s, dtype=torch.int32, device=device)

    store = {
        "lock_hi": z(n_records),
        "lock_lo": z(n_records),
        "ver": z(n_records),
    }
    if protocol == "mvcc":
        # slot 0 seeded as the initial committed version (wts = (0, 1))
        store["wts_hi"] = z(n_records, n_versions)
        wts_lo = z(n_records, n_versions)
        wts_lo[:, 0] = 1
        store["wts_lo"] = wts_lo
        store["rts_hi"] = z(n_records)
        store["rts_lo"] = z(n_records)
        store["vdata"] = torch.full(
            (n_records, n_versions, rw), init_value, dtype=torch.int32, device=device
        )
        store["vver"] = z(n_records, n_versions)
    else:
        store["data"] = torch.full((n_records, rw), init_value, dtype=torch.int32, device=device)
    if protocol == "occ":
        store["seq"] = z(n_records)
    if protocol == "sundial":
        store["wts_hi"] = z(n_records)
        store["wts_lo"] = z(n_records)
        store["rts_hi"] = z(n_records)
        store["rts_lo"] = z(n_records)
    return store
