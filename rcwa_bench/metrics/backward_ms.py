"""backward_ms: the gradient's backward pass, ms per unit.  A driver that
takes the gradient itself spans it ('backward'); in the ADAM loop it is
``optim._value_and_grad``'s span less the forward solve inside it."""


def read(ctx, name):
    back = ctx.spans.ms('backward')
    if back:
        return sum(back) / len(back)
    vg = ctx.spans.ms('value_and_grad')
    if not vg:
        return None
    return (sum(vg) - sum(ctx.spans.ms('solve'))) / len(vg)
