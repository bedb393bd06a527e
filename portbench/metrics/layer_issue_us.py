"""Host time per decoder layer of the decode chunk's issue: the program's
``merlin.decoder.layers`` span inside ``merlin.engine.decode``, per busy
step (in the window outside a traced run's profiled part), over the
configuration's ``num_hidden_layers``."""

from portbench import spans


def read(rec):
    per = spans.per_step(rec, (spans.LAYERS,), parent=spans.DECODE)
    if per is None:
        return None
    return 1e6 * sum(per) / len(per) / rec.lm["num_hidden_layers"]
