"""CHORUS keypoint-filter grammar (reference: ``constants/filtering.py:1-76``).

A copy of ``coma_tpu/config/filtering.py`` (the port imports nothing of
``coma_tpu``).

The reference carries 15 named keypoint-visibility filters inherited from
CHORUS. Each entry is a pair ``(coco_filter, wholebody_filter)`` — the
first grammar string is evaluated against COCO-style keypoint visibility,
the second against COCO-Wholebody visibility (every shipped wholebody
filter is the permissive ``"|"``). No reference main-path script consumes
the table (it is config surface for the no-keypoint-filtering ablation,
``filtering.py:76``), but users migrating CHORUS-era configs expect the
grammar to parse and evaluate identically, so it is ported as a small
executable spec rather than dead data.

Grammar (one string)::

    required_part | banned_part

* ``required_part`` is ``/``-separated GROUPS; every group must be
  satisfied. A group is a ``,``-separated list of keypoint names, at
  least ONE of which must be visible (comma = OR within a group,
  slash = AND across groups). An empty required part imposes nothing.
* ``banned_part`` is ``/``-separated keypoint names, NONE of which may
  be visible. (The shipped tables never use ``,`` in the banned part;
  a comma there is accepted and treated like ``/`` — both separate
  names whose visibility is forbidden.)
* Whitespace around names is ignored. ``"|"`` (both parts empty)
  accepts everything — filter 15, "no keypoint filter".

Evaluation is pure-Python set logic (host-side prefilter config, not a
jit path): visibility arrives as the set of visible keypoint names, or a
``{name: bool}`` mapping.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Mapping, Tuple

__all__ = [
    "KEYPOINT_FILTERS",
    "DEFAULT_KEYPOINT_FILTER_NUM",
    "DEFAULT_FILTER_SETTING_NUM",
    "DO_SHUFFLE_WHEN_NO_KPFILTER",
    "KeypointFilter",
    "parse_keypoint_filter",
    "keypoint_filter_passes",
]

# The 15 filter settings, verbatim from the reference table
# (``constants/filtering.py:2-72``; first element COCO, second Wholebody).
KEYPOINT_FILTERS: dict[int, Tuple[str, str]] = {
    # 1. [face (hand allowed)]
    1: (
        "nose/left_eye/right_eye/left_ear/right_ear | left_knee/right_knee/left_ankle/right_ankle/left_hip_extra/right_hip_extra",
        "|",
    ),
    # 2. [face (strict)]
    2: (
        "nose/left_eye/right_eye/left_ear/right_ear | left_knee/right_knee/left_ankle/right_ankle/left_hip_extra/right_hip_extra/left_wrist/right_wrist/left_elbow/right_elbow",
        "|",
    ),
    # 3. [full body (one of shoulder, one of hip)]
    3: (
        "left_shoulder,right_shoulder / left_hip_extra,right_hip_extra | ",
        "|",
    ),
    # 4. [full body (one of shoulder, one of hip, one of elbow or hand)]
    4: (
        "left_shoulder,right_shoulder / left_hip_extra,right_hip_extra / left_elbow, right_elbow | ",
        "|",
    ),
    # 5. [full body (one of shoulder, one of hip, one of knees or ankle)]
    5: (
        "left_shoulder,right_shoulder / left_hip_extra,right_hip_extra / left_knee, right_knee, left_ankle, right_ankle | ",
        "|",
    ),
    # 6. [hand (elbow, shoulder allowed: both sides available)]
    6: (
        "left_wrist, right_wrist | left_knee/right_knee/left_ankle/right_ankle/left_hip_extra/right_hip_extra/nose/left_eye/right_eye/left_ear/right_ear",
        "|",
    ),
    # 7. [hand (elbow allowed: both sides available)]
    7: (
        "left_wrist, right_wrist | left_knee/right_knee/left_ankle/right_ankle/left_hip_extra/right_hip_extra/nose/left_eye/right_eye/left_ear/right_ear/left_shoulder/right_shoulder",
        "|",
    ),
    # 8. [hand (strict: both sides available)]
    8: (
        "left_wrist, right_wrist | left_knee/right_knee/left_ankle/right_ankle/left_hip_extra/right_hip_extra/nose/left_eye/right_eye/left_ear/right_ear/left_shoulder/right_shoulder/left_elbow/right_elbow",
        "|",
    ),
    # 9. [hand (elbow allowed: only left)]
    9: (
        "left_wrist | left_knee/right_knee/left_ankle/right_ankle/left_hip_extra/right_hip_extra/nose/left_eye/right_eye/left_ear/right_ear/left_shoulder/right_shoulder/right_wrist/right_elbow",
        "|",
    ),
    # 10. [hand (elbow allowed: only right)]
    10: (
        "right_wrist | left_knee/right_knee/left_ankle/right_ankle/left_hip_extra/right_hip_extra/nose/left_eye/right_eye/left_ear/right_ear/left_shoulder/right_shoulder/left_wrist/left_elbow",
        "|",
    ),
    # 11. [full body (one of shoulder, one of hip, one of knees, one of ankle)]
    11: (
        "left_shoulder,right_shoulder / left_hip_extra,right_hip_extra / left_knee, right_knee / left_ankle, right_ankle | ",
        "|",
    ),
    # 12. [face (hand allowed, side view allowed)]
    12: (
        "left_eye,right_eye/left_ear,right_ear,nose | left_knee/right_knee/left_ankle/right_ankle/left_hip_extra/right_hip_extra",
        "|",
    ),
    # 13. [face (strict, side view allowed)]
    13: (
        "left_eye,right_eye/left_ear,right_ear,nose | left_knee/right_knee/left_ankle/right_ankle/left_hip_extra/right_hip_extra/left_wrist/right_wrist/left_elbow/right_elbow",
        "|",
    ),
    # 14. [face+body]
    14: ("nose/left_eye,right_eye/left_ear,right_ear /left_shoulder,right_shoulder | ", "|"),
    # 15. [no keypoint filter]
    15: ("|", "|"),
}

DEFAULT_KEYPOINT_FILTER_NUM = 3
DEFAULT_FILTER_SETTING_NUM = 3

# For the "No-Keypoint Filtering" experiment (``filtering.py:76``).
DO_SHUFFLE_WHEN_NO_KPFILTER = True


@dataclass(frozen=True)
class KeypointFilter:
    """Parsed form: ``required`` is a tuple of OR-groups (each a frozenset
    of names, at least one of which must be visible); ``banned`` is a
    frozenset of names, none of which may be visible."""

    required: Tuple[frozenset, ...]
    banned: frozenset

    def __call__(self, visible) -> bool:
        return keypoint_filter_passes(self, visible)


def _names(part: str, seps=("/",)) -> list[str]:
    for s in seps[1:]:
        part = part.replace(s, seps[0])
    return [n.strip() for n in part.split(seps[0]) if n.strip()]


def parse_keypoint_filter(expr: str) -> KeypointFilter:
    """Parse one grammar string (see module docstring)."""
    if expr.count("|") != 1:
        raise ValueError(
            f"keypoint filter needs exactly one '|' separator: {expr!r}")
    req_part, ban_part = expr.split("|")
    required = tuple(
        frozenset(_names(group, seps=(",",)))
        for group in req_part.split("/")
        if group.strip()
    )
    banned = frozenset(_names(ban_part, seps=("/", ",")))
    return KeypointFilter(required=required, banned=banned)


def keypoint_filter_passes(
    filt: KeypointFilter | str | int,
    visible: Iterable[str] | Mapping[str, bool],
    *,
    wholebody: bool = False,
) -> bool:
    """True iff the visibility assignment satisfies the filter.

    ``filt`` may be a parsed :class:`KeypointFilter`, a grammar string, or
    a filter number from :data:`KEYPOINT_FILTERS` (then ``wholebody``
    selects the tuple member). ``visible`` is the set of visible keypoint
    names, or a name->bool mapping.
    """
    if isinstance(filt, int):
        filt = KEYPOINT_FILTERS[filt][1 if wholebody else 0]
    if isinstance(filt, str):
        filt = parse_keypoint_filter(filt)
    if isinstance(visible, Mapping):
        vis = {k for k, v in visible.items() if v}
    else:
        vis = set(visible)
    if any(not (group & vis) for group in filt.required):
        return False
    return not (filt.banned & vis)
