"""Walk steps per advance call (``WalkResult.advance_calls``)."""


def read(rec):
    calls = sum(t["advance_calls"] for t in rec["tasks"])
    return sum(t["steps"] for t in rec["tasks"]) / calls if calls else None
