"""Preemption-safe resume tokens (counterpart of
localai_tpu/engine/resume.py; the JSON is the wire contract between the two
packages' backends, so a token one writes parses in the other).

A ``ResumeToken`` is a host-side snapshot of everything a generation slot
needs to continue after the backend process dies or is preempted: the
original prompt ids, the tokens emitted so far, the per-slot sampler RNG
key (device state read back at preempt time), the characters already
released downstream, the KV chain hashes spilled into the host pool, and
the remaining deadline budget.

Resume is a normal request whose prompt is ``prompt_ids + emitted``: KV
reuse falls out of the prefix cache and the HostKVPool readmission path,
and the per-token counts admission rebuilds match the uninterrupted run.
The extra fixups (RNG key install, grammar and detokenizer replay, no
re-emission of text already sent) are driven by the ``resume`` payload on
``GenRequest``.

Stdlib only, so any process can round-trip tokens without torch.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

RESUME_VERSION = 1


@dataclasses.dataclass
class ResumeToken:
    """Checkpoint of one in-flight generation."""

    prompt_ids: list[int]            # original prompt token ids
    emitted: list[int]               # token ids emitted before preemption
    key: list[int] | None = None     # per-slot RNG key (2 x u32) read from
                                     # the device sampler at preempt; None
                                     # for greedy or hard-death resumes
    sent_chars: int = 0              # detokenized chars already released
    generated: int = 0               # emitted-token count (len(emitted)
                                     # unless the caller trimmed the list)
    chain: list[str] = dataclasses.field(default_factory=list)
                                     # hex chain hashes of the full KV
                                     # blocks spilled to the host pool
    deadline_left: float = 0.0       # remaining per-request budget (s);
                                     # 0 = no deadline
    request_id: str = ""             # original request id (log continuity)
    model: str = ""                  # model name the slot belonged to

    def __post_init__(self) -> None:
        if self.generated == 0:
            self.generated = len(self.emitted)

    @property
    def resume_prompt(self) -> list[int]:
        """Prompt for the resume request: original prompt + emitted."""
        return list(self.prompt_ids) + list(self.emitted)

    def payload(self) -> dict[str, Any]:
        """Engine-side ``GenRequest.resume`` payload."""
        return {
            "emitted": len(self.emitted),
            "key": list(self.key) if self.key is not None else None,
            "sent_chars": int(self.sent_chars),
        }

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["v"] = RESUME_VERSION
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), separators=(",", ":"))

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ResumeToken":
        if int(d.get("v", RESUME_VERSION)) != RESUME_VERSION:
            raise ValueError(f"unsupported resume token version {d.get('v')}")
        key = d.get("key")
        return cls(
            prompt_ids=[int(t) for t in d.get("prompt_ids", [])],
            emitted=[int(t) for t in d.get("emitted", [])],
            key=[int(k) for k in key] if key is not None else None,
            sent_chars=int(d.get("sent_chars", 0)),
            generated=int(d.get("generated", 0)),
            chain=[str(h) for h in d.get("chain", [])],
            deadline_left=float(d.get("deadline_left", 0.0)),
            request_id=str(d.get("request_id", "")),
            model=str(d.get("model", "")),
        )

    @classmethod
    def from_json(cls, s: str) -> "ResumeToken":
        return cls.from_dict(json.loads(s))
