"""One driver a traffic entry: each sets its cell up, measures its window,
optionally traces a stretch, and checks what the timed path produced
against the plain reference."""
