"""(wet, hydro) delay pairs delivered per second: every pair of every request
the window started, over the time from the first request's start to the last
request's end (host clock)."""


def read(ctx):
    return ctx.pairs / ctx.window_s
