"""Set-up: from the start of the process to the start of the window
(imports, inputs, the program's set-up, kernel builds, warm-up)."""


def read(ctx):
    return ctx.setup_s
