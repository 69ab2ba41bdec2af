"""Host synchronizations of one control step of the env (`TrainingEnv.step`
or `EvalEnv.step` with the task and the physics inside), counted under
`torch.cuda.set_sync_debug_mode("warn")` (`_trace.host_syncs`): the reader
of `env_host_syncs.train` and `env_host_syncs.eval`."""


def read(obs):
    return obs.get("host_syncs")
