"""The host's kernel launch calls a traced step."""


def read(t):
    if t.launch_calls == 0:
        return None
    return t.launch_calls / t.steps
