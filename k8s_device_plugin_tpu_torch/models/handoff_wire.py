"""The disaggregated handoff's wire names: engine roles, the prefill
route, the logits section's magic and the headers a router and a replica
exchange.

Kept apart from ``engine_handoff`` (which re-exports them) and free of
torch, so the router, which sends and reads these headers, loads with
the standard library and numpy only, as the reference's router does.
"""

ROLES = ("unified", "prefill", "decode")
# tpu_engine_role gauge values.
ROLE_VALUES = {"unified": 0, "prefill": 1, "decode": 2}

PREFILL_ROUTE = "/v1/prefill"
# The /v1/prefill stream's optional trailing logits section.
LOGITS_MAGIC = b"TPUHOLG1"
# Router -> decode replica: the prefill replica to pull from ("host:port"),
# or the LOCAL sentinel (run the prefill yourself).
HANDOFF_SOURCE_HEADER = "X-Handoff-Source"
HANDOFF_LOCAL = "local"
# Decode replica -> caller on a 409: how many full prefix pages are missing.
PREFILL_NEEDED_HEADER = "X-Prefill-Needed"
# On a /v1/prefill request: stream resident pages only, never run a probe.
FABRIC_RESIDENT_ONLY_HEADER = "X-Fabric-Resident-Only"
