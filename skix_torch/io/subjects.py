"""Multi-modality subject discovery.

A copy of ``skix/io/subjects.py`` (host code, the standard library only).

Reference parity: bundle_adjustment/main.py:19,65 (``SubjectData`` /
``build_subject_map`` — scan N modality roots, intersect person ids) and
the same pattern in front_side/main.py:126. One shared implementation.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Dict, Mapping, Optional

log = logging.getLogger(__name__)


@dataclasses.dataclass
class SubjectData:
    """Per-person paths across modalities (missing modality → None)."""

    person: str
    paths: Dict[str, Path]

    def __getitem__(self, modality: str) -> Optional[Path]:
        return self.paths.get(modality)


def build_subject_map(roots: Mapping[str, str | Path],
                      require_all: bool = True) -> Dict[str, SubjectData]:
    """Scan each modality root's person directories; return subjects keyed
    by person id. ``require_all=True`` keeps only the intersection
    (reference semantics); otherwise the union with None gaps."""
    per_modality: Dict[str, Dict[str, Path]] = {}
    for modality, root in roots.items():
        root = Path(root)
        persons = {}
        if root.exists():
            for d in sorted(p for p in root.iterdir() if p.is_dir()):
                persons[d.name] = d
        else:
            log.warning("modality %s root missing: %s", modality, root)
        per_modality[modality] = persons

    if require_all:
        keys = None
        for persons in per_modality.values():
            keys = set(persons) if keys is None else keys & set(persons)
        keys = keys or set()
    else:
        keys = set()
        for persons in per_modality.values():
            keys |= set(persons)

    out = {}
    for person in sorted(keys):
        out[person] = SubjectData(
            person=person,
            paths={m: persons.get(person)
                   for m, persons in per_modality.items()})
    log.info("subject map: %d persons across %d modalities",
             len(out), len(roots))
    return out
