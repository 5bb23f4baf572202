"""search_s: the window's wall seconds over the whole searches it held
(every search started in the window runs to its end inside it)."""


def read(run):
    return run.window_s / run.searches if run.searches else None
