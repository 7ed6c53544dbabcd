"""output_tok_per_s: output tokens delivered to clients by the steps that
ended inside the window, over the window's seconds."""


def read(run):
    return sum(s.tokens for s in run.window_steps()) / run.seconds
