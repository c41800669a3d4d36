"""Shared by the span readers: a span's host-clock milliseconds in the
window, a proof."""


def per_proof_ms(run, span: str):
    if run.tracer is None or not run.proofs or not run.tracer.window_span_calls[span]:
        return None
    return run.tracer.window_span_s[span] * 1e3 / run.proofs
