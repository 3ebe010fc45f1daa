"""pad_ms: the executor's packer (``serve/executor.py::_pack_batch``: pinned
buffers, embedding, the copy to the card), mean host time per batch in the
window, from the program's ``slate_serve_pad_seconds`` histogram."""


def read(run, spec):
    total, count = run.counters.get("slate_serve_pad_seconds", (0.0, 0))
    if count <= 0:
        return None
    return 1e3 * total / count
