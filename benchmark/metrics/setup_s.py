"""setup_s: seconds from the harness's start to the window's (imports, the
libraries built or loaded, the inputs made, the warm job; host clock)."""


def read(ctx):
    return ctx.setup_s
