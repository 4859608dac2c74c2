"""Host ms from the call into `train_step` to its return (no
synchronisation), averaged over every step of the traced window: the
trainer's dispatch (train/trainer.py, parallel/dp.py, train/optim.py), in
a cell whose pace it sets (it takes longer than the card's work a step)."""


def read(t):
    return sum(t.dispatch_ms) / len(t.dispatch_ms) if t.dispatch_ms else None
