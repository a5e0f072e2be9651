"""host_prep_ms_per_frame.offline: the worker's ``prepare_chunk`` spans
(host preprocessing, the wire encoding, the copy to the device) in ms, per
frame prepared."""


def read(log, cell):
    spans = log.rec.spans.get("prepare", [])
    if log.driver != "offline" or not spans:
        return None
    return sum(b - a for a, b, _ in spans) * 1e3 / sum(n for *_, n in spans)
