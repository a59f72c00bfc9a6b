"""Host ms a video frame spends before its dispatch (the CLI loop's
`IllustripSetup.frame` and `draw`: prompts, motion, draws), the mean over
the window's frames, timed around the same calls `illustrip._run` makes."""


def read(lay: dict):
    prep = lay.get("prep_s")
    if not prep:
        return None
    return 1e3 * sum(prep) / len(prep)
