"""Host ms a slot in the learners' updates: the slot's D3PG updates
(``t2drl.slot_updates``) and the episode's DDQN updates
(``t2drl.ddqn_updates``), less their minibatch draws (``replay.sample``,
which ``replay_ms.train`` reads), over the traced episode's slots."""
from perfbench.lib import spans


def read(ctx):
    return spans.ms_per(ctx, ("t2drl.slot_updates", "t2drl.ddqn_updates"),
                        "slots", minus=("replay.sample",))
