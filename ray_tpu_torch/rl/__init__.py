"""ray_tpu_torch.rl: RL training on the actor/task runtime (RLlib-equivalent).

Role-equivalent to the reference's RLlib core split (rllib/):
- EnvRunnerGroup (env/env_runner_group.py) -> EnvRunner/QEnvRunner actors
  collecting from gymnasium vector envs with numpy policy forwards;
- LearnerGroup (core/learner/learner_group.py:101) -> torch learners on one
  device each (``device=None`` means the GPU; the algorithm configs pass
  ``device`` through);
- Algorithm (algorithms/algorithm.py) -> Tune-trainable-shaped drivers:
  - PPO (on-policy): broadcast weights, parallel sample, GAE, minibatched
    clipped-surrogate updates;
  - DQN (off-policy): replay-buffer actor (uniform/prioritized,
    rllib/utils/replay_buffers/) fed by ASYNC collectors that overlap
    learning (IMPALA-shaped pipeline), double-Q target network, PER
    importance weights;
- Offline RL (algorithms/{bc,cql}/) -> rl/offline.py: BC + CQL trained
  from saved transition datasets streamed through ray_tpu_torch.data;
- Multi-agent (env/multi_agent_env.py + multi_agent_env_runner.py) ->
  rl/multi_agent.py: per-agent dict env ABC, per-policy runner batching,
  independent PPO with policy_mapping_fn routing.
"""
from ray_tpu_torch.rl.dqn import DQN, DQNConfig
from ray_tpu_torch.rl.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rl.multi_agent import (
    CueMatchEnv,
    MultiAgentEnv,
    MultiAgentEnvRunner,
    MultiAgentPPO,
    MultiAgentPPOConfig,
)
from ray_tpu_torch.rl.ppo import PPO, PPOConfig
from ray_tpu_torch.rl.offline import (
    BC,
    BCConfig,
    CQL,
    CQLConfig,
    collect_transitions,
    evaluate_policy,
    load_transitions,
    save_transitions,
)
from ray_tpu_torch.rl.sac import SAC, SACConfig
from ray_tpu_torch.rl.replay_buffer import (
    PrioritizedReplayBuffer,
    ReplayBuffer,
    ReplayBufferActor,
)

__all__ = [
    "BC",
    "BCConfig",
    "CQL",
    "CQLConfig",
    "DQN",
    "DQNConfig",
    "CueMatchEnv",
    "IMPALA",
    "IMPALAConfig",
    "MultiAgentEnv",
    "MultiAgentEnvRunner",
    "MultiAgentPPO",
    "MultiAgentPPOConfig",
    "PPO",
    "PPOConfig",
    "SAC",
    "SACConfig",
    "PrioritizedReplayBuffer",
    "ReplayBuffer",
    "ReplayBufferActor",
    "collect_transitions",
    "evaluate_policy",
    "load_transitions",
    "save_transitions",
]
