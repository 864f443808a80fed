"""Seconds from process start to the window's start: imports, inputs from
the seed, the program's graph build, upload, kernel load, model build and
the first steps."""


def read(ctx):
    return ctx.setup_s
