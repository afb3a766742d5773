"""PaddleGAN's CycleGAN (horse2zebra), written once against the 2.x API of
the package passed in (`paddle_tpu` or `paddle_tpu_torch`).  It imports
neither: the parity test builds it with both, and `chip_smoke.py` with
the port.

Source: PaddleGAN configs/cyclegan_horse2zebra.yaml, with
ppgan/models/generators/resnet.py (`ResnetGenerator`),
ppgan/models/discriminators/nlayers.py (`NLayerDiscriminator`) and
ppgan/models/cycle_gan_model.py.  The sizes of `HORSE2ZEBRA` are this
program's reading of them:
- generator (ngf 64, 9 blocks): reflect Pad2D 3, Conv2D(3, 64, 7), IN,
  ReLU; two downsamplings Conv2D(k 3, s 2, p 1), IN, ReLU (64 -> 128 ->
  256); nine residual blocks at 256 (reflect pad 1, conv 3, IN, ReLU,
  reflect pad 1, conv 3, IN, plus the skip); two upsamplings
  Conv2DTranspose(k 3, s 2, p 1, output_padding 1), IN, ReLU (256 -> 128
  -> 64); reflect pad 3, Conv2D(64, 3, 7), Tanh.  IN is
  InstanceNorm2D(weight_attr=False, bias_attr=False), and the
  convolutions carry a bias (`use_bias`: the norm is instance norm);
- discriminator: the 70 x 70 PatchGAN (ndf 64, 3 layers), every conv k 4,
  p 1: Conv(3, 64, s 2), LeakyReLU(0.2); Conv(64, 128, s 2) and
  Conv(128, 256, s 2), each IN, LeakyReLU; Conv(256, 512, s 1), IN,
  LeakyReLU; Conv(512, 1, s 1);
- weights N(0, 0.02), biases 0 (PaddleGAN's init_weights 'normal', gain
  0.02), drawn here from one numpy stream in state_dict order so both
  packages start from the same weights;
- losses: LSGAN (MSELoss against 1 and 0), cycle L1Loss with lambda_A =
  lambda_B = 10, identity 0.5 lambda;
- training: Adam(2e-4, beta1 0.5, beta2 0.999) for the two generators
  together and for the two discriminators together; one step is G_A and
  G_B (the discriminators frozen), then D_A and D_B on fakes drawn
  through an image pool of 50 (its coin and slot from a seeded numpy
  generator); batch 1 at 256 x 256, float32.

`upsample="output_padding"` (the default) is PaddleGAN's upsampling
layer.  `upsample="crop"` is Conv2DTranspose(k 3, s 2, p 0) followed by
the slice [1:2H+1]: the same function under the scatter definition of a
transposed convolution, and one that both packages compute alike (the
reference's output_padding zero-fills the last row and column).

Data are synthetic, from a seed: horse2zebra is not in the repository.
"""

from __future__ import annotations

import numpy as np

HORSE2ZEBRA = dict(ngf=64, ndf=64, n_blocks=9, n_layers=3, size=256,
                   batch=1, lr=2e-4, beta1=0.5, beta2=0.999, lambda_a=10.0,
                   lambda_b=10.0, lambda_identity=0.5, pool_size=50)
# the test's cut
TINY = dict(HORSE2ZEBRA, ngf=8, ndf=8, n_blocks=2, n_layers=2, size=32)

_CLASSES = {}


def classes(P):
    """The program's layers, subclassing P.nn.Layer (made once a
    package)."""
    if P.__name__ in _CLASSES:
        return _CLASSES[P.__name__]
    nn = P.nn

    def norm(c):
        return nn.InstanceNorm2D(c, weight_attr=False, bias_attr=False)

    class ResnetBlock(nn.Layer):
        def __init__(self, dim):
            super().__init__()
            self.conv_block = nn.Sequential(
                nn.Pad2D([1, 1, 1, 1], mode="reflect"),
                nn.Conv2D(dim, dim, 3, padding=0), norm(dim), nn.ReLU(),
                nn.Pad2D([1, 1, 1, 1], mode="reflect"),
                nn.Conv2D(dim, dim, 3, padding=0), norm(dim))

        def forward(self, x):
            return x + self.conv_block(x)

    class CropUp(nn.Layer):
        """Conv2DTranspose(k 3, s 2, p 0), then rows and columns 1 to 2H."""

        def __init__(self, cin, cout):
            super().__init__()
            self.conv = nn.Conv2DTranspose(cin, cout, 3, stride=2,
                                           padding=0)

        def forward(self, x):
            h, w = x.shape[2], x.shape[3]
            return self.conv(x)[:, :, 1:2 * h + 1, 1:2 * w + 1]

    class ResnetGenerator(nn.Layer):
        def __init__(self, ngf, n_blocks, upsample="output_padding"):
            super().__init__()
            layers = [nn.Pad2D([3, 3, 3, 3], mode="reflect"),
                      nn.Conv2D(3, ngf, 7, padding=0), norm(ngf), nn.ReLU()]
            for i in range(2):
                m = 2 ** i
                layers += [nn.Conv2D(ngf * m, ngf * m * 2, 3, stride=2,
                                     padding=1), norm(ngf * m * 2),
                           nn.ReLU()]
            layers += [ResnetBlock(ngf * 4) for _ in range(n_blocks)]
            for i in range(2):
                m = 2 ** (2 - i)
                cin, cout = ngf * m, ngf * m // 2
                if upsample == "output_padding":
                    up = nn.Conv2DTranspose(cin, cout, 3, stride=2,
                                            padding=1, output_padding=1)
                elif upsample == "crop":
                    up = CropUp(cin, cout)
                else:
                    raise ValueError(f"upsample {upsample!r}")
                layers += [up, norm(cout), nn.ReLU()]
            layers += [nn.Pad2D([3, 3, 3, 3], mode="reflect"),
                       nn.Conv2D(ngf, 3, 7, padding=0), nn.Tanh()]
            self.model = nn.Sequential(*layers)

        def forward(self, x):
            return self.model(x)

    class NLayerDiscriminator(nn.Layer):
        def __init__(self, ndf, n_layers):
            super().__init__()
            seq = [nn.Conv2D(3, ndf, 4, stride=2, padding=1),
                   nn.LeakyReLU(0.2)]
            mult = 1
            for n in range(1, n_layers):
                prev, mult = mult, min(2 ** n, 8)
                seq += [nn.Conv2D(ndf * prev, ndf * mult, 4, stride=2,
                                  padding=1), norm(ndf * mult),
                        nn.LeakyReLU(0.2)]
            prev, mult = mult, min(2 ** n_layers, 8)
            seq += [nn.Conv2D(ndf * prev, ndf * mult, 4, stride=1,
                              padding=1), norm(ndf * mult),
                    nn.LeakyReLU(0.2),
                    nn.Conv2D(ndf * mult, 1, 4, stride=1, padding=1)]
            self.model = nn.Sequential(*seq)

        def forward(self, x):
            return self.model(x)

    ns = dict(ResnetBlock=ResnetBlock, CropUp=CropUp,
              ResnetGenerator=ResnetGenerator,
              NLayerDiscriminator=NLayerDiscriminator)
    _CLASSES[P.__name__] = ns
    return ns


def init_normal(model, seed):
    """Every weight N(0, 0.02) and every bias 0, from a numpy stream of
    `seed` in state_dict order."""
    rng = np.random.RandomState(seed)
    state = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        state[k] = (np.zeros(shape, "float32") if len(shape) == 1 else
                    (rng.randn(*shape) * 0.02).astype("float32"))
    model.set_state_dict(state)
    return model


def build(P, cfg, seed=0, upsample="output_padding"):
    """{"G_A", "G_B", "D_A", "D_B"}: the two generators and the two
    PatchGAN discriminators, each initialised from its own seed."""
    ns = classes(P)
    nets = {
        "G_A": ns["ResnetGenerator"](cfg["ngf"], cfg["n_blocks"], upsample),
        "G_B": ns["ResnetGenerator"](cfg["ngf"], cfg["n_blocks"], upsample),
        "D_A": ns["NLayerDiscriminator"](cfg["ndf"], cfg["n_layers"]),
        "D_B": ns["NLayerDiscriminator"](cfg["ndf"], cfg["n_layers"]),
    }
    for i, k in enumerate(("G_A", "G_B", "D_A", "D_B")):
        init_normal(nets[k], seed + i)
    return nets


def n_params(model):
    return sum(int(np.prod(p.shape)) for p in model.parameters())


def images(cfg, seed=0):
    """(real_A, real_B) as numpy (B, 3, size, size) in [-1, 1]."""
    rng = np.random.RandomState(seed)
    shape = (cfg["batch"], 3, cfg["size"], cfg["size"])
    return (rng.uniform(-1, 1, shape).astype("float32"),
            rng.uniform(-1, 1, shape).astype("float32"))


class ImagePool:
    """CycleGAN's history of generated images (ppgan/utils/image_pool.py):
    until it holds `pool_size` images each new one goes in and is
    returned; then with probability 1/2 a random stored image is
    returned and replaced by the new one, else the new one is returned.
    The coin and the slot come from a numpy generator of `seed`."""

    def __init__(self, pool_size, seed=0):
        self.pool_size = pool_size
        self.images = []
        self.rng = np.random.RandomState(seed)

    def query(self, P, images):
        if self.pool_size == 0:
            return images
        out = []
        for i in range(images.shape[0]):
            image = images[i:i + 1].detach()
            if len(self.images) < self.pool_size:
                self.images.append(image)
                out.append(image)
            elif self.rng.uniform(0, 1) > 0.5:
                j = int(self.rng.randint(0, self.pool_size))
                out.append(self.images[j])
                self.images[j] = image
            else:
                out.append(image)
        return P.concat(out, axis=0)


def _set_trainable(P, net, flag):
    for p in net.parameters():
        p.stop_gradient = not flag


def _gan_loss(P, pred, real):
    target = P.ones_like(pred) if real else P.zeros_like(pred)
    return P.nn.MSELoss()(pred, target)


def generator_losses(P, nets, real_a, real_b, cfg):
    """The generators' six losses (identity A and B, GAN A and B, cycle
    A and B) with the discriminators frozen, and the fakes."""
    l1 = P.nn.L1Loss()
    la, lb = cfg["lambda_a"], cfg["lambda_b"]
    lid = cfg["lambda_identity"]
    fake_b = nets["G_A"](real_a)
    rec_a = nets["G_B"](fake_b)
    fake_a = nets["G_B"](real_b)
    rec_b = nets["G_A"](fake_a)
    _set_trainable(P, nets["D_A"], False)
    _set_trainable(P, nets["D_B"], False)
    losses = {
        "idt_A": l1(nets["G_A"](real_b), real_b) * (lb * lid),
        "idt_B": l1(nets["G_B"](real_a), real_a) * (la * lid),
        "G_A": _gan_loss(P, nets["D_A"](fake_b), True),
        "G_B": _gan_loss(P, nets["D_B"](fake_a), True),
        "cycle_A": l1(rec_a, real_a) * la,
        "cycle_B": l1(rec_b, real_b) * lb,
    }
    return losses, fake_a, fake_b


def discriminator_loss(P, net, real, fake):
    """(GAN(D(real), 1) + GAN(D(fake), 0)) / 2, the fake detached."""
    return (_gan_loss(P, net(real), True)
            + _gan_loss(P, net(fake.detach()), False)) * 0.5


def optimizers(P, nets, cfg):
    adam = dict(learning_rate=cfg["lr"], beta1=cfg["beta1"],
                beta2=cfg["beta2"])
    return {"G": P.optimizer.Adam(parameters=list(
        nets["G_A"].parameters()) + list(nets["G_B"].parameters()), **adam),
        "D": P.optimizer.Adam(parameters=list(
            nets["D_A"].parameters()) + list(nets["D_B"].parameters()),
            **adam)}


def pools(cfg, seed=0):
    return {"A": ImagePool(cfg["pool_size"], seed),
            "B": ImagePool(cfg["pool_size"], seed + 1)}


def train_step(P, nets, opts, pool, real_a, real_b, cfg):
    """One CycleGAN step (the generators, then the discriminators);
    returns the losses as 0-d tensors (nothing is read to the host)."""
    losses, fake_a, fake_b = generator_losses(P, nets, real_a, real_b, cfg)
    loss_g = losses["idt_A"] + losses["idt_B"] + losses["G_A"] \
        + losses["G_B"] + losses["cycle_A"] + losses["cycle_B"]
    loss_g.backward()
    opts["G"].step()
    opts["G"].clear_grad()
    _set_trainable(P, nets["D_A"], True)
    _set_trainable(P, nets["D_B"], True)
    losses["D_A"] = discriminator_loss(P, nets["D_A"], real_b,
                                       pool["B"].query(P, fake_b))
    losses["D_B"] = discriminator_loss(P, nets["D_B"], real_a,
                                       pool["A"].query(P, fake_a))
    (losses["D_A"] + losses["D_B"]).backward()
    opts["D"].step()
    opts["D"].clear_grad()
    losses["G"] = loss_g
    return losses
