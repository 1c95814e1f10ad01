"""Host ms a serving call: the median time the program's root span
(``xp.pipe.call``) takes on the host, over the untraced calls it keeps in
its ring. With calls dispatched ahead of the card, this is the time to
queue a call's launches, waits for a full launch queue included."""
from xpbench import records


def read(ctx):
    return records.host_ms(ctx)
