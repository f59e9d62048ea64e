"""The loops that drive an entry through the window, one module each,
named by a traffic file's ``"loop"`` (``closed`` where it names none):
``run(entry, seconds, sync, mark) -> (calls, kept, failed)``, where
``calls`` are the (start, end) host seconds of each call the window
holds, ``kept`` the last output of each input set, and ``failed`` the
count of calls that raised.  ``sync`` waits for the card; ``mark(name)``,
None in an untraced run, opens a span of the trace around a call."""
