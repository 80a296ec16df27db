"""roundtrip.host_syncs: CUDA runtime calls a call that make the host wait for
the card, among those that start inside the program's ``roundtrip.call``
spans: stream, device and event synchronisations, blocking ``cudaMemcpy`` and
``cudaFree``.  The profiler records the runtime's calls as host events.  A
pageable copy from the host is ``cudaMemcpyAsync`` then
``cudaStreamSynchronize``: one wait.
"""

import bisect

CALL = "roundtrip.call"
WAITS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy",
                   "cudaFree"})


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["calls"]:
        return None
    calls = sorted((a, b) for a, b, name in tr.host if name == CALL)
    if not calls:
        return None
    starts = [a for a, _ in calls]
    waits = 0
    for a, _, name in tr.host:
        if name in WAITS:
            i = bisect.bisect_right(starts, a) - 1
            waits += i >= 0 and a <= calls[i][1]
    return waits / ctx["calls"]
