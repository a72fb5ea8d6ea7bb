"""Online-learned step-size controllers: GAN-modulated and RL (policy
gradient) steppers, on batches.

Counterpart of `multioptpy_tpu/steppers/learned.py`. Both controllers keep
their MLP parameters inside the stepper state, (W (B, in, out), b (B, out))
per layer, and train them by one inline SGD update per step; the gradients
come from `torch.autograd.grad` of the per-row losses summed (rows are
independent, so each row's gradient is its own), in place of `jax.grad`.
Initial parameters are drawn from an explicit `torch.Generator`; the RL
policy's normal draw comes from a generator carried in the state (`key`),
or from `noise` when the caller passes one (the stream of `jax.random`
cannot be reproduced).

Both modulate a base step (the driver hands in the steepest-descent move):
  gan:  move = base * (1 + 0.5 * tanh(G(feat)))   per DOF
  rl:   move = base * exp(a),  a ~ N(mu, sigma)   one multiplier per row
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

from multioptpy_tpu_torch.steppers.first_order import ring_slot


def _mlp_init(generator, sizes, dtype=torch.float64, device=None):
    """He-initialized MLP parameters as a tuple of (W, b), unbatched."""
    params = []
    for i in range(len(sizes) - 1):
        w = torch.randn((sizes[i], sizes[i + 1]), generator=generator,
                        dtype=dtype) * (2.0 / sizes[i]) ** 0.5
        params.append((w.to(device),
                       torch.zeros((sizes[i + 1],), dtype=dtype,
                                   device=device)))
    return tuple(params)


def _mlp_apply(params, x):
    """x (B, K, in) through batched layers -> (B, K, out); leaky ReLU 0.2
    between layers."""
    for i, (w, b) in enumerate(params):
        x = x @ w + b[:, None, :]
        if i < len(params) - 1:
            x = F.leaky_relu(x, 0.2)
    return x


def _sgd(params, loss_fn, lr):
    """One SGD step on every (W, b) of `params` against loss_fn(params),
    a (B,) loss per row."""
    flat = [t for layer in params for t in layer]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in flat]
        layers = tuple(zip(leaves[::2], leaves[1::2]))
        grads = torch.autograd.grad(loss_fn(layers).sum(), leaves)
    new = [t - lr * g for t, g in zip(flat, grads)]
    return tuple(zip(new[::2], new[1::2]))


# --------------------------------------------------------------------------
# GAN step
# --------------------------------------------------------------------------

class GanState(NamedTuple):
    gen: tuple                 # generator params: feat(3) -> scale(1)
    disc: tuple                # discriminator params: feat(3)+de(1) -> logit
    buf_feat: torch.Tensor     # (B, R, D, 3) replay ring of features
    buf_de: torch.Tensor       # (B, R) energy changes
    buf_n: torch.Tensor        # (B,) int32
    prev_energy: torch.Tensor  # (B,)
    prev_feat: torch.Tensor    # (B, D, 3) features of the step just taken
    count: torch.Tensor        # (B,) int32


def gan_init(dim, generator=None, buffer_size=32, dtype=torch.float64,
             device=None):
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    gen = _mlp_init(generator, (3, 32, 32, 1), dtype, device)
    disc = _mlp_init(generator, (4, 32, 1), dtype, device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return GanState(gen, disc, zeros(buffer_size, dim, 3), zeros(buffer_size),
                    torch.tensor(0, dtype=torch.int32, device=device),
                    torch.tensor(float("inf"), dtype=dtype, device=device),
                    zeros(dim, 3),
                    torch.tensor(0, dtype=torch.int32, device=device))


def gan_step(state, x, gradient, energy, base_step, lr=1e-3):
    """Modulate `base_step` per DOF by the generator after one SGD step of
    the discriminator (real = the energy went down, over the replay ring)
    and of the generator (fool the previous discriminator). x, gradient,
    base_step (B, D); energy (B,)."""
    dtype = x.dtype
    feat = torch.stack([x, gradient, base_step], dim=-1)       # (B, D, 3)
    feat = feat / (feat.abs().amax(1, keepdim=True) + 1e-12)

    # learn from the previous step's outcome
    de_n = torch.tanh((energy - state.prev_energy)
                      / (energy.abs() + 1e-10) * 1e3)
    have = state.count > 0
    r = state.buf_feat.shape[1]
    put = ring_slot(state.buf_n, r) & have[:, None]
    buf_feat = torch.where(put[..., None, None], state.prev_feat[:, None],
                           state.buf_feat)
    buf_de = torch.where(put, de_n[:, None], state.buf_de)
    buf_n = state.buf_n + have.to(torch.int32)
    valid = (torch.arange(r, device=x.device)
             < torch.clamp(buf_n, max=r)[:, None]).to(dtype)

    def disc_loss(disc):
        inp = torch.cat([buf_feat.mean(2), buf_de[..., None]], dim=-1)
        logit = _mlp_apply(disc, inp)[..., 0]                  # (B, R)
        label = (buf_de < 0).to(dtype)
        bce = (torch.clamp(logit, min=0) - logit * label
               + torch.log1p(torch.exp(-logit.abs())))
        return (bce * valid).sum(-1) / torch.clamp(valid.sum(-1), min=1.0)

    def modulated(gen):
        scale = torch.tanh(_mlp_apply(gen, feat)[..., 0])
        return base_step * (1.0 + 0.5 * scale)

    def gen_loss(gen):
        fm = feat.mean(1)
        inp = torch.stack([fm[:, 0], fm[:, 1], modulated(gen).mean(-1),
                           torch.full_like(fm[:, 0], -1.0)], dim=-1)
        logit = _mlp_apply(state.disc, inp[:, None, :])[:, 0, 0]
        return -F.logsigmoid(logit)

    disc = _sgd(state.disc, disc_loss, lr)
    gen = _sgd(state.gen, gen_loss, lr)
    move = modulated(gen)
    ok = ((move * gradient).sum(-1) < 0) & torch.isfinite(move).all(-1)
    move = torch.where(ok[:, None], move, base_step)
    return move, GanState(gen, disc, buf_feat, buf_de, buf_n,
                          energy.to(dtype), feat, state.count + 1)


# --------------------------------------------------------------------------
# RL step-size policy
# --------------------------------------------------------------------------

class RlState(NamedTuple):
    policy: tuple                # params: summary(4) -> (mu, log_sigma)
    key: torch.Generator         # the normal draw's stream
    baseline: torch.Tensor       # (B,) running reward mean
    prev_energy: torch.Tensor    # (B,)
    prev_summary: torch.Tensor   # (B, 4)
    prev_action: torch.Tensor    # (B,)
    count: torch.Tensor          # (B,) int32


def rl_init(dim, generator=None, dtype=torch.float64, device=None, seed=1):
    """Policy parameters from `generator` (seeded with `seed` when None);
    the state's draw stream is a generator on `device` seeded with `seed`."""
    del dim
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    policy = _mlp_init(generator, (4, 64, 2), dtype, device)
    key = torch.Generator(device=device or "cpu").manual_seed(seed)
    return RlState(policy, key, torch.tensor(0.0, dtype=dtype, device=device),
                   torch.tensor(float("inf"), dtype=dtype, device=device),
                   torch.zeros((4,), dtype=dtype, device=device),
                   torch.tensor(0.0, dtype=dtype, device=device),
                   torch.tensor(0, dtype=torch.int32, device=device))


def _rl_summary(gradient, base_step, energy):
    gn = torch.linalg.vector_norm(gradient, dim=-1)
    return torch.stack([torch.log1p(gn),
                        torch.log1p(torch.linalg.vector_norm(base_step,
                                                             dim=-1)),
                        torch.tanh(energy), torch.ones_like(gn)], dim=-1)


def rl_step(state, gradient, energy, base_step, lr=3e-3, sigma_min=0.02,
            noise=None):
    """REINFORCE update of the policy from the previous transition (reward
    = normalized energy decrease, running baseline), then a log-multiplier
    a ~ N(mu, sigma) clipped to [-1.5, 1.5]: move = base * exp(a).
    `noise` (B,) is the standard-normal draw; None draws it from
    `state.key`."""
    dtype = gradient.dtype
    reward = torch.tanh(-(energy - state.prev_energy)
                        / (energy.abs() + 1e-10) * 1e3)
    have = (state.count > 0).to(dtype)
    advantage = (reward - state.baseline) * have

    def logp(policy, summary, action):
        out = _mlp_apply(policy, summary[:, None, :])[:, 0]
        mu, log_sigma = out[:, 0], out[:, 1]
        sigma = torch.exp(torch.clamp(log_sigma, -3.0, 1.0)) + sigma_min
        return (-0.5 * ((action - mu) / sigma) ** 2 - torch.log(sigma),
                mu, sigma)

    policy = _sgd(state.policy, lambda p: -(advantage * logp(
        p, state.prev_summary, state.prev_action)[0]), lr)
    baseline = 0.9 * state.baseline + 0.1 * reward * have

    summary = _rl_summary(gradient, base_step, energy)
    if noise is None:
        noise = torch.randn(gradient.shape[:1], generator=state.key,
                            dtype=dtype, device=gradient.device)
    _, mu, sigma = logp(policy, summary, torch.zeros_like(energy))
    action = torch.clamp(mu + sigma * noise, -1.5, 1.5)
    move = base_step * torch.exp(action)[:, None]
    ok = torch.isfinite(move).all(-1)
    move = torch.where(ok[:, None], move, base_step)
    return move, RlState(policy, state.key, baseline, energy.to(dtype),
                         summary, action, state.count + 1)
