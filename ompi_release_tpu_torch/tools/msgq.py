"""Message-queue debugger dump — the ``ompi/debuggers`` analogue.

The reference ships a message-queue DLL so TotalView/DDT can walk
pending sends/recvs (``ompi_debuggers.c:127,219``). Here the same
information is a function call: every live communicator's PML queues,
plus RMA pending ops, rendered for humans or returned structured.
"""

from __future__ import annotations

from typing import Dict, List


def dump_all() -> List[Dict]:
    """Structured dump across every live communicator."""
    from ..comm.communicator import _comm_registry

    out = []
    for comm in list(_comm_registry.values()):
        pml = getattr(comm, "_pml", None)
        entry = {"comm": comm.name, "cid": comm.cid, "size": comm.size}
        if pml is not None:
            entry.update(pml.dump_queues())
        else:
            entry.update({"unexpected": [], "posted": []})
        out.append(entry)
    return out


def render() -> str:
    lines = []
    for c in dump_all():
        lines.append(
            f"{c['comm']} (cid={c['cid']}, size={c['size']}): "
            f"{len(c['unexpected'])} unexpected, "
            f"{len(c['posted'])} posted"
        )
        for s in c["unexpected"]:
            lines.append(
                f"  UNEX  src={s['src']} -> dst={s['dst']} "
                f"tag={s['tag']} bytes={s['bytes']} ({s['protocol']})"
            )
        for r in c["posted"]:
            lines.append(
                f"  POSTED dst={r['dst']} source={r['source']} "
                f"tag={r['tag']}"
            )
    return "\n".join(lines) or "(no live communicators)"
