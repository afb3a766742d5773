"""Drive paddle_tpu_torch on one NVIDIA GPU: build the hand-written
kernels, hold each against its plain PyTorch version at BERT-base shapes,
serve BERT-base through serving.Engine, decode with BERT-base as a causal
decoder through serving.AutoregressiveEngine, take BERT-base pretraining
steps on both arms of the fused FFN, train ResNet-50 eagerly, as a
Fluid static-graph program through fluid.Executor and through the 2.x
front end's hapi.Model.fit, train and decode the Transformer-base WMT
model, run the quickstart's 2.x modes, train and decode Paddle 2.x's
seq2seq with attention and the book's semantic-role-labelling program
(a Fluid program through fluid.Executor), train MobileNetV2, VGG16 and
PaddleGAN's CycleGAN, decode the seq2seq model through a 1.x While
program, train the static ResNet-50 in fp16, train, quantize and decode
PaddleCV's MobileNet-SSD through the detection rules, train and serve
PaddleRec's CTR-DNN through the dataset path, checkpoint and resume it,
export BERT-base to an inference Predictor and serve it beside the CTR
model from one ModelRegistry, serve BERT-base's encoder and LeNet through
the inference C ABI from a ctypes host and a pure-C host, train MNIST
from files through the 1.x readers and PyReader, train BERT-base and the
static ResNet-50 data-parallel over torch.distributed, train BERT-base
tensor-parallel and the static ResNet-50 with its state sharded (ZeRO
through Fleet, data x fsdp x tp through the compiler's SPMD arm), with
int8 quantized gradient collectives and a sharded checkpoint resumed,
train BERT-base sequence-parallel (ring and Ulysses attention), and
check what comes out.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero and prints no result):
  1. card     nvidia-smi name and power limit
  2. build    nvcc for sm_90a, every csrc/*.cu in parallel
  3. kernels  each kernel (flash forward, dkv and dq backward; FFN
              forward, dW and dx backward; ragged paged attention) vs its
              plain version on the card at the paths' shapes (stated
              tolerances), timed beside its plain version, a PyTorch
              library call computing the same function, and its bound;
              the flash forward also at B*H edges of its plan (each case
              run twice for the same bits) and graph-timed in turns with
              SDPA, at BERT-base and at the decode prefills; the flash
              backward's two kernels graph-timed in turns with SDPA's
              backward, at dropout 0.1 (the path) and 0; the FFN
              forward also over T = 16 (12 layers' weights cycling cold),
              64, 256, 512, 4096 and 16384 tokens, each point checked,
              run twice for the same bits and graph-timed in turns with
              the cuBLAS arm, beside its bound and plan; the dW and dx
              rows each beside the arm's calls that compute their own
              outputs, dx graph-timed in turns with its arm and swept
              over d_model 128-1024, T = 1-16384, every activation, with
              and without dropout; the ragged kernel at a decode step
              (split path) and a 256-token chunk (tiled path), every
              lane held against the plain version twice (the same bits),
              graph-timed in turns with index_select + SDPA, its plan and
              bound logged; the element pass of the FFN's library arm
              (ffn_act_fwd, ffn_act_bwd) at bf16 and f32, its vector and
              per-value paths, the dropout mask bit for bit, timed at
              T=16384, F=3072 beside its bound; paged_attention in f32
              at head_dim 80 (inputs the ragged kernel does not take):
              the dense arm, each call counted as
              serving_ragged_fallback_total, no ragged launch; then the
              WMT shapes (_wmt_kernel_holds): flash_fwd, dkv and dq at
              the cross-attention's (32, T=120 | S=128, 8, 64), with and
              without a key-padding bias, dropout 0.1 and 0; flash_fwd
              at the decode steps' Sq = 1 against 1, 7, 32 and 128 keys
              (B*H = 256); the relu element pass at (3840, 2048) bit for
              bit; each twice for the same bits, graph-timed beside SDPA
              (its backward) or ATen's bias + relu and the bound
  4. probe    the layout probe (paddle_tpu_torch.tools.kernel4d_probe) at
              its defaults, B=8, S=512, H=12, D=64: the three layout kernels
              (4d, fold3d, merged) checked against its reference and timed
              in CUDA-graph chains beside flash_fwd and SDPA; exact launch
              counts; then each of the three vs its plain version at
              (8,512,12,64), (2,200,12,64), (4,512,6,128) and
              (2,2048,4,64), the three bit for bit alike (merged once
              unmerged), the same bits on a second launch at the tool's
              shape, and each timed alone there
  5. slice    BertModel(BertConfig.base()) in bf16 with seeded weights,
              served through serving.Engine(max_batch_size=32) to
              requests of 1-16 rows at S=512 from several client threads;
              every response finite and equal to a direct forward of the
              same rows; each forward kernel launched 12 times per call
  6. decode   BertForPretraining(BertConfig.base()) in bf16 with seeded
              weights as a causal LayeredDecoder (bert_decoder below)
              through serving.AutoregressiveEngine: 16 slots, 513 pages
              of 16 tokens, prompt buckets 64/128/256, chunk 256.  Part A:
              16 requests (prompts 64-256, 96 new tokens each); once all
              16 decode, 32 steps timed with CUDA events under
              torch.cuda.set_sync_debug_mode("error"), then 8 steps under
              torch.profiler.  Part B: 16 more requests (prompts 16-448,
              four over 256, 16-64 new tokens) submitted while part A
              decodes, run until idle.  Checks: exact token counts, each
              token's logit within DECODE_LOGIT_TOL of the largest logit
              of a dense causal forward of its prefix (teacher forcing),
              every page freed, one device->host sync per retirement,
              exact launch counts of every kernel, and 0 calls sent to
              the dense paged arm
  7. train    (the FFN's kernel arm, enable_fused_ffn(), pinned in
              main() for phases 3-9 and 12)
              build_pretrain_step on BertForPretraining(BertConfig.base())
              (fp32 masters, bf16 forward, dropout 0.1, AdamW lr 1e-4) at
              B=32, S=512, 76 masked positions: 1 warm-up and 5 timed
              steps on one batch; finite falling loss, finite moments (no
              NaN gradient), each of the six training kernels launched 12
              times a step; step ms, tokens/s, MFU, kernel shares, peak
              memory
  8. profile  one more train step under torch.profiler: device time by
              kernel and the device's idle share
  9. ffn_arms the train phase's steps on the FFN's default library arm
              (cuBLAS products around ffn_act_fwd / ffn_act_bwd): 0 FFN
              kernel launches, 12 a step of each element pass and flash
              kernel, the dispatch counters; one step profiled; the
              serving forward of 32 x 512 under both arms in turns
 10. coverage BertConfig.tiny() in f32 on the card (dense attention, the
              library arm in f32) against the CPU
 11. check    the same model at base width, 2 layers, on the card (bf16)
              against the plain path on the CPU (f32)
 12. resnet   ResNet-50 train steps at bench_resnet50's configuration
              (B=128, 224^2, bf16 over fp32 masters, momentum SGD lr 0.1):
              1 warm-up and RESNET_STEPS timed steps, finite falling
              losses, finite velocities and moved running statistics, no
              hand-written kernel launched; step ms, images/s, MFU, peak
              memory, one step profiled; then resnet18 in f32 on the card
              against the CPU (and the same step with TF32 on, read only,
              to show what the tolerance would let through)
 13. fluid    the Fluid static graph: BASELINE.json configs[1]'s program
              (models/resnet.build_train_program at its defaults:
              ResNet-50, 1000 classes, B=128, 224^2, f32 as declared,
              Momentum lr 0.1 + L2Decay 1e-4) built with the port's
              fluid, its startup program run on the card, then through
              fluid.Executor(): 1 warm-up and FLUID_TIMED steps timed by
              CUDA events with return_numpy=False under
              set_sync_debug_mode("error"), more to step FLUID_STEPS + 1;
              finite losses falling by then (the whole curve printed),
              finite velocities, moved running statistics, exact op and
              run counts, 0 syncs, no hand-written kernel launched; step
              ms, images/s, MFU, host dispatch an op, peak memory, one
              step profiled; then static resnet18 on the card against
              the CPU Executor, and MNIST (configs[0], Adam)
 14. wmt      BASELINE.json configs[2]: WMTTransformer(TransformerConfig.
              base()) (vocabularies of 30000, d_model 512, 8 heads of 64,
              6 + 6 pre-norm layers, d_ff 2048, relu, dropout 0.1, label
              smoothing 0.1; 90.2 M parameters) with seeded weights.
              Training through build_train_step (bf16 over fp32 masters,
              Adam b2 0.997 eps 1e-9, Noam warm-up WMT_WARMUP = 100) at B=32,
              S=128, T=120 from fake_batch, on the FFN's default library
              arm: 1 warm-up and WMT_TIMED steps timed by CUDA events
              under set_sync_debug_mode("error"), exact launches a step
              (flash_fwd, dkv, dq, ffn_act_fwd, ffn_act_bwd 12 each, FFN
              kernels 0) and dispatches (6 dense: the decoder's causal
              self-attention; 12 library FFN calls); steps to WMT_STEPS
              = 20 with a finite loss that falls by then (the curve
              alike to four decimals in three processes on the H100),
              finite moments,
              every tensor moved (the two position tables too) but the
              k_proj biases (exact gradient 0); step ms, source and
              target tokens/s, MFU, peak memory, one step profiled; one
              step with enable_fused_ffn() (the six kernels 12 each).
              Decoding in bf16 (eval): 8 sources of 128 tokens to 32
              tokens, greedy, beam 4 and beam 1, timed under
              set_sync_debug_mode("error"): 6 + 12 a step flash_fwd
              launches each, 0 dense dispatches; greedy equals beam 1
              token for token; beam 4's scores best first, and its best
              >= beam 1's - 1e-5 wherever greedy's sequence is one of its
              final beams (beam search is not monotone in the width:
              elsewhere the difference is printed, not held); each
              greedy token's logit within DECODE_LOGIT_TOL of
              the largest of a full forward over its prefix (teacher
              forcing); ms a step, tokens/s, one greedy decode profiled
 15. hapi     the 2.x front end on BASELINE.json configs[1]:
              resnet50(1000 classes) through hapi.Model.fit on the
              static-mode adapter at amp O1 (bf16 over fp32 masters),
              Momentum over PiecewiseDecay with L2 1e-4,
              Accuracy(topk=(1, 5)), one epoch of HAPI_IMAGES synthetic
              uint8 images (B=128, 224^2) through io.DataLoader (4
              process workers and their pinned ring, the buffer reader): 16
              steps, finite losses, no hand-written kernel launched; ms a
              step (steps 2-16), images/s, MFU, peak memory, host syncs a
              step by line, the ratio to the resnet phase's step; the
              loader alone (0 workers, 4 through the ring); the same
              fit over one staged batch; train_batch's
              host ms by stage and host ops, in turns with the hand-built
              step on the same module; one step profiled.  Checks:
              evaluate's top-1/top-5 equal a numpy recount of predict's
              logits on HAPI_EVAL_IMAGES images; Model.save then
              Model.load into a fresh model gives the same predictions
              bit for bit, the same optimizer state and the same next
              loss (HAPI_RELOAD_RTOL); resnet18's Model.fit in f32 on the
              card against the CPU (one step, then three)
 16. dygraph  examples/quickstart_mnist.py's run_dygraph (line for line:
              its float(loss.numpy()) on a CUDA tensor) and run_hapi on
              LeNet on the card through the port's names; the first
              dygraph step's loss and gradients against the CPU
              (LENET_TOL); every loss finite; one step of a 1.x
              fluid.dygraph net (Conv2D act relu, Pool2D, Linear act
              softmax) through .numpy(), .gradient() and
              clear_gradients(), its loss and gradients against the CPU
              (LENET_TOL), and a save_dygraph / load_dygraph round trip
              of its parameters and Adam state (the next loss equal)
 17. seq2seq  Paddle 2.x's seq2seq with attention for IWSLT'15 en-vi
              (tests/torch_seq2seq_program.py at IWSLT15: PaddleNLP's
              seq2seq_attn defaults; uniform +-0.1 weights from a seed),
              the 2.x API over the port: S2S_STEPS Model.fit steps on one
              staged synthetic batch (B=128, T=50, f32) through the
              static-mode adapter, Adam 1e-3 with the global-norm clip
              5.0; the loss falls (S2S_FALL), no hand-written kernel
              launched; ms a step (CUDA events, host clock beside),
              tokens/s, peak memory, syncs a step by line, one step
              profiled.  The encoder's cuDNN LSTM against its plain
              loop, forward and gradients (S2S_LSTM_TOL, S2S_LSTM_GRAD).
              Decoding the 128 sources with BeamSearchDecoder(10) and
              dynamic_decode (up to S2S_MAX_LEN steps): beam 1 equals a
              greedy loop over the same cell; each beam of 10, followed
              back through its parents, scores what teacher forcing
              scores (S2S_SCORE_TOL); ms a step, tokens/s, syncs a step
 18. srl      the book's semantic-role-labelling program
              (tests/torch_srl_program.py at BOOK: db_lstm of depth 8,
              512 wide, CoNLL-05's vocabularies; random weights from the
              startup program, a synthetic batch B=10, T=64) through
              fluid.Executor: SRL_STEPS SGD steps over exponential_decay,
              the loss falls, no hand-written kernel launched, every
              lstm op on the loop arm; ms a step (CUDA events, host clock
              beside), live tokens/s, the idle share of a profiled step,
              syncs a step by line, ops a step and host us an op, peak
              memory, the crf_decoding ms.  The same program at depth 2
              and 32 wide, and the book's word2vec, recommender and
              sentiment programs (tests/torch_book_programs.py), on the
              card against the CPU Executor from the same state
              (SRL_LOSS_RTOL, SRL_STATE_TOL, the decoded paths equal);
              the lstm rule's cuDNN arm against its loop (SRL_ARM_TOL)
 19. mobilenet  vision.models.mobilenet_v2() (3.5 M parameters, Dropout
              0.2 live) and vgg16() (138 M, Dropout 0.5) trained through
              vision.train.build_train_step at the resnet phase's
              configuration (B=128, 224^2, bf16 over fp32 masters,
              momentum SGD lr 0.1; VGG16 at VGG_LR = 0.001), cuDNN's
              search on: 1 warm-up and
              MOBILE_TIMED steps each, finite losses falling, moved
              running statistics, finite velocities, no hand-written
              kernel launched; step ms, images/s, MFU (conv_net_fwd_flops
              from the layer shapes), peak memory, host syncs a step, one
              step profiled with the depthwise convolutions' device time
              named; then mobilenet_v2(scale=0.25) and
              vgg11(batch_norm=True) in f32 on the card against the CPU
              (RESNET_TOL, RESNET_KINK)
 20. cyclegan PaddleGAN's CycleGAN (tests/torch_cyclegan_program.py at
              HORSE2ZEBRA: two ResnetGenerators of ngf 64 with 9 blocks,
              two 70 x 70 PatchGANs, LSGAN + cycle + identity losses, Adam
              2e-4 (0.5, 0.999) for each pair, image pools of 50; B=1,
              256^2, f32) through the port's 2.x API: 1 warm-up and
              CG_TIMED steps on one seeded pair, finite losses, the cycle
              loss falling, finite Adam moments, the first upsampling's
              output_padding row nonzero, 0 host syncs a step, no
              hand-written kernel launched; step ms, images/s, peak
              memory, one step profiled; the generator cut to 2 blocks
              on the card against the CPU (CG_TOL, RESNET_KINK) and its
              output_padding form against its crop form on the card
 21. static_decode  the seq2seq model's inference half as a 1.x static
              program (tests/torch_seq2seq_static_program.py at IWSLT15:
              embedding + dynamic_lstm, the decoder cell written out from
              matmul / split / sigmoid / tanh, a While block over
              capacity-S2S_MAX_LEN tensor arrays) through fluid.Executor,
              B=128, T=50, f32, the seq2seq phase's seed: greedy ids
              equal the 2.x greedy loop's token for token; at beam
              S2S_BEAM each beam's score within S2S_SCORE_TOL of teacher
              forcing; no hand-written kernel launched; decode ms a step
              (CUDA events, host clock beside), steps, host reads and
              syncs a step by line, ops a step and host us an op, one
              beam decode profiled, and the 2.x beam decode and the
              static one in turns; the two programs at STATIC_CUT sources
              on the card against the CPU Executor (ids equal, scores
              within S2S_SCORE_TOL)
 22. fluid_amp  BASELINE configs[1]'s static ResNet-50 program
              (tests/torch_fluid_amp_program.py: build_train_program at
              B=128, 224^2 with its optimizer= argument) trained in fp16
              through fluid.contrib.mixed_precision.decorate(
              LarsMomentumOptimizer) with fleet's amp_configs and
              lars_configs, EMA(0.9999) updated after each step: 1
              warm-up and AMP_STEPS steps, AMP_TIMED of them timed (CUDA
              events, host clock beside) with the host syncs counted by
              line (1 a step: the update block's condition), the loss
              scale and its counts against the update_loss_scaling
              rule's replay of the fetched overflow flags, the loss
              falling over the steps that applied; ops a step, host us an
              op, peak memory, one step profiled; inside ema.apply() each
              parameter is its shadow and the for_test clone runs, after
              it each is its training tensor again; two steps at
              float32's largest loss scale skip the update bit for bit,
              keep the scale, then halve it.  Then the f32 program with
              the configs[1] Momentum, plain and under RecomputeOptimizer
              (the 16 blocks' outputs as checkpoints), from one state:
              the same loss (RECOMPUTE_LOSS_RTOL), each update within
              RECOMPUTE_UPDATE_L2, a lower peak, both step times.  The
              sixteen fluid optimizers, ClipGradByGlobalNorm, ModelAverage
              and Lookahead on the cut resnet18, card against the CPU
              Executor (FLUID_LOSS_RTOL, RESNET_KINK), and the decorated
              program there too, with every op in f32 (the same limits)
              and in fp16 (AMP_CUT_LOSS, the same flags and scales).  The
              random rules at
              RANDOM_DRAWS draws by their statistics, shuffle_channel
              equal to the CPU's
 23. ssd      PaddleCV's MobileNet-SSD on Pascal VOC
              (tests/torch_ssd_program.py at FULL: MobileNet V1 at scale
              1.0 with its four extra blocks, multi_box_head over six maps,
              1917 priors, 21 classes, 300^2, B=64, Paddle's ssd_loss
              composed from the detection rules, RMSProp lr 0.001 over
              piecewise_decay with L2Decay 5e-5, f32) through
              fluid.Executor with cuDNN's search on: 1 warm-up and
              SSD_TIMED steps timed (CUDA events, host clock beside),
              SSD_STEPS in all, the loss finite and falling, 0 host reads
              and 0 syncs a step, no hand-written kernel launched; ms a
              step, images/s, ops a step, host us an op, peak memory, the
              idle share and top device ops of a profiled step.  Decoding
              the batch through detection_output (multiclass_nms3) on the
              trained scope: ms, detections an image, padding rows,
              DetectionMAP (reported, not held); detection_output alone
              on the full width's head outputs, card against CPU (counts
              equal; every row whose score is separated from the other
              candidates' by more than a tie, SSD_TIE_ULPS, alike within
              SSD_DET_TOL; a row on one side only must be such a tie).
              The program through
              fluid.contrib.slim's QuantizationTransformPass: 1 warm-up and
              SSD_QAT_STEPS timed, its ms against the float step, the
              quant ops inserted, every observer scale finite and
              positive.  The cut program (SMALL), float and QAT, on the
              card against the CPU Executor (SSD_LOSS_RTOL, SSD_UPDATE,
              SSD_MOMENT, SSD_STATE; QAT_LOSS_RTOL, QAT_SCALE) and the cut
              decode program (counts and labels equal); each case of
              tests/torch_det_cases.py (every detection and quantize
              rule) on the card against the CPU (DET_RULE_TOL)

 24. ctr      PaddleRec's CTR-DNN on Criteo (tests/torch_ctr_program.py
              at FULL: 13 dense features, 26 slots into one [1000001, 10]
              table, fc 400 x 3, softmax, auc over 4096 thresholds, Adam
              1e-4, B=1000) through fluid.DatasetFactory: CTR_FILES
              synthetic MultiSlot files of CTR_LINES lines written by
              MultiSlotDataGenerator, loaded by an InMemoryDataset with
              CTR_THREADS parser threads (s and lines/s) and shuffled;
              a warm-up pass, then one timed pass of 100 steps through
              Executor.train_from_dataset(CompiledProgram) with the
              counts at 0: ms a step by CUDA events (host clock beside),
              samples/s, ops a step, host us an op, host reads and syncs,
              the ring's occupancy, waits and stall attribution, peak
              memory; the loss finite and falling (the last 10 steps'
              mean below the first 10's), the AUC above 0.5; the idle
              share, host-to-device copies a step and top device ops of
              a profiled pass.  A QueueDataset pass against an
              unshuffled InMemoryDataset pass from the same weights
              (CTR_QUEUE_RTOL) and its samples/s; CompiledProgram's
              first 3 steps equal to Executor.run's bit for bit;
              FLAGS_check_nan_inf's cost a step, and a planted NaN
              raising within prefetch_depth steps, naming a variable;
              save_persistables / load_persistables into a fresh scope
              bit for bit; save_inference_model of [predict, auc],
              load_inference_model into a fresh scope and
              infer_from_dataset over the held-out file against the
              trained scope's forward (CTR_INFER_RTOL, the auc
              histograms equal), ms a batch; SMALL trained on the card
              against the CPU Executor over the same files and weights
              (CTR_LOSS_RTOL, CTR_UPDATE, the histograms equal).  No
              hand-written kernel is on this path (0 launches)
 25. deploy   checkpoints, export and serving two tenants.  (a) CTR-DNN at
              FULL through train_from_dataset(CompiledProgram) over
              DEPLOY_FILES files of DEPLOY_LINES lines (12 steps at
              B=1000): passes from one state without checkpoints, with one
              every DEPLOY_EVERY steps, and without again (the losses
              within DEPLOY_RESUME_RTOL; ms a step by CUDA events, commits
              and their bytes, the writer's ms a commit, a snapshot's host
              enqueue and device copy and their share of the steps); a
              pass preempted by an exception from step_callback after
              step DEPLOY_PREEMPT, resumed in a fresh Executor and Scope
              (the startup program's random values overwritten) from the
              last checkpoint: the remaining losses within
              DEPLOY_RESUME_RTOL, the updates and Adam's moments within
              CTR_UPDATE of the uninterrupted pass.  (b) BertModel(base)
              in bf16 (eval) through inference.save_inference_model at
              (DEPLOY_BATCH, SEQ) under the default FFN arm and under
              enable_fused_ffn, and load_inference_model: the graph holds
              12 paddle_tpu_torch::flash_forward and 12 ::ffn_act_fwd
              (::ffn_forward) operators; one Predictor.run with the counts
              at 0 launches flash_fwd and ffn_act_fwd (ffn_fwd) 12 times;
              its outputs against the eager model's (SERVE_MAX_ABS,
              SERVE_MEAN_ABS).  (c) one ModelRegistry serving "bert" (the
              default-arm Predictor) and "ctr" (a ProgramModel over the
              CTR inference program saved from the untrained weights and
              loaded by fluid.io.load_inference_model), each with its
              quota and priority, from two client threads each, the
              counts at 0: mid-traffic reload_weights("ctr", (a)'s
              checkpoint root), bert answering during it; each ctr
              response equals the direct run
              of the program on the old or the new weights
              (DEPLOY_CTR_TOL), every one submitted after the reload the
              new; every bert response finite and the first 8 against the
              eager model; 12 flash_fwd and ffn_act_fwd launches a bert
              model call; per-tenant p50/p99, completions, rejections;
              then a burst past ctr's quota refused for tenant:ctr alone
              beside admitted bert requests, and unregister("ctr")
              cancelling its queued requests while bert's are answered.
              (d) tests/torch_ckpt_worker.py on the card at
              DEPLOY_KILL_CFG (the table cut to 100003 rows, B=256): a
              worker SIGKILLed at a step boundary and restarted against
              an uninterrupted one, each loss within DEPLOY_RESUME_RTOL
 26. capi     the inference C ABI: csrc/c_api.cc built by g++ with
              libpython (core_native.build_c_api(embed=True)).  (a)
              BERT-base's encoder in bf16 behind one float32 tensor in
              and out (_EncoderF32), exported at DEPLOY_BATCH x SEQ x 768
              under the default FFN arm: 12 flash_forward and 12
              ffn_act_fwd operators in the graph; a ctypes host in a clean
              subprocess (nothing of torch or the port loaded before
              PT_NewPredictor) runs PT_Init, PT_NewPredictor and
              PT_PredictorRun: its output equals the in-process
              Predictor.run bit for bit and is within SERVE_MAX_ABS /
              SERVE_MEAN_ABS of the eager encoder, one call launches
              flash_fwd and ffn_act_fwd 12 times each and nothing else
              (counted in the host's process), the -2 contract and a bad
              prefix hold, and CAPI_RUNS calls are timed in turns with
              run_handles + the host copy (host clock and CUDA events).
              (b) examples/c_inference/predictor_demo.c compiled
              unchanged by gcc against the library, serving LeNet
              exported on the card: its printed logits within
              CAPI_LENET_TOL of the in-process Predictor's
 27. feed     BASELINE configs[0] from files: MNIST-format IDX gzip files
              of FEED_TRAIN images written from FEED_SEED; models/mnist.py
              (Adam 1e-3) for one epoch at FEED_BATCH fed by paddle.batch
              over reader.shuffle(reader.map_readers(..., dataset.mnist
              .train(...))) through fluid.io.PyReader, and through
              DataLoader.from_generator over xmap_readers (FEED_WORKERS,
              ordered), from one state, cuDNN deterministic: the first
              FEED_HOLD losses bit for bit a numpy-fed run's, finite
              falling losses, 0 launches; seconds, samples/s, host ms
              waiting on the feed against Executor.run, host reads and
              syncs a step, the idle share of the epoch's last
              FEED_PROFILED steps under the profiler.  Then a batch
              generator of tensors already on the card: they reach the
              Executor as the same objects, 0 syncs a step, the first
              FEED_HOLD losses bit for bit the numpy-fed run's
 28. dist     data parallelism over torch.distributed, the ranks started
              by the port's distributed.spawn under the PADDLE_* contract
              and loading the kernels the build phase built.  With two or
              more cards one NCCL group of min(cards, 4) ranks, a card
              each; with one card a world-one NCCL group, then two ranks
              sharing the card under gloo (PADDLE_DISTRI_BACKEND=gloo).
              (a) every collective rule on CUDA tensors against numpy
              oracles of the same shards (DIST_RULE_TOL), the comm-stream
              all-reduce behind its fence; (b) BERT-base's data-parallel
              build_pretrain_step at full width, bf16 over f32 masters,
              AdamW, dropout 0, the global batch DIST_BERT_BATCH x 512
              with 76 masked split over the ranks, DIST_STEPS steps: the
              parameters' bits the same on every rank after each step,
              each rank's kernel launches counted, step ms, all-reduce ms
              a step (CUDA events and host clock) and bytes; the
              rank-mean losses within DIST_LOSS1_RTOL (step 1) and
              DIST_LOSS_RTOL of one process on the whole batch on this
              card; (c) BASELINE configs[4]'s
              Fleet path on the static ResNet-50 (fleet.init ->
              distributed_optimizer(Momentum) -> GraphExecutionOptimizer
              -> GradAllReduce -> CompiledProgram.with_data_parallel),
              global batch DIST_RESNET_BATCH at 224^2, f32, per-rank batch
              norm: one c_allreduce_sum a gradient, the parameters the
              same on every rank after each step, step 1's losses the
              one-process forwards of the same rows, finite losses; then
              one step with BuildStrategy.sync_batch_norm, whose rank-mean
              loss is within DIST_SBN_RTOL of the whole batch's
              one-process forward; (d) the same Fleet path with
              FLAGS_quant_collectives=int8 (the gradients' c_allreduce_sum
              as int8 blocks and fp32 scales), its losses within
              QUANT_HEALTH_RTOL of full width and its wire bytes
              QUANT_MIN_DROP fewer
 29. spmd     model parallelism (parallel/, models/bert.py mp_axis):
              the flash kernels at a tensor-parallel rank's heads (q/k/v
              (32, 512, 3, 64), heads 6-8 of 12, dropout 0.1) and the FFN
              kernels and ffn_act at its d_ff columns (T=16384, columns
              1536-2303 of 3072) against their plain versions at those
              offsets and, bit for bit, the whole width's launch sliced
              (ffn_act's mask bit for bit with _ffn_keep), timed there
              beside bound, plain version and library call; then ranks
              started by distributed.spawn (four or more cards: one NCCL
              group of 4, a card each; else two gloo ranks sharing the
              card): BERT-base's tensor-parallel step (mp_axis) at full
              width, bf16, dropout 0.1, SPMD_STEPS steps on {dp: 1, mp:
              ranks} (B=32 under NCCL, 8 under gloo, S=512, 76 masked),
              each rank's launches counted, step ms, param and moment
              bytes a rank, the replicated masters' bits the same on
              every rank, the losses within SPMD_LOSS_RTOL and the
              gathered masters within SPMD_MASTER_ATOL of rank 0's
              one-process step on the same batch and seed; with four
              ranks {dp: 2, mp: 2} at dropout 0 likewise; the static
              ResNet-50 of the dist phase, SPMD_RESNET_STEPS steps,
              through Fleet's sharding at stages 1 and 3 (each rank's
              losses within SPMD_RESNET_RTOL
              of the plain Fleet run's, its accumulator bytes a rank's
              share) and through BuildStrategy.mesh_axes {data: 1, fsdp:
              2, tp: 2} ({data: 1, fsdp: 2} on two ranks; the fc weight
              and its velocity one shard a rank, the losses within
              SPMD_RESNET_RTOL of the same mesh with every spec P()), and
              {data: 1, fsdp: ranks} with FLAGS_quant_collectives=int8
              against full width (the gradients over the batch axes as
              int8, losses within
              QUANT_HEALTH_RTOL of full width, their wire bytes
              QUANT_MIN_DROP fewer); a sharded checkpoint on the SPMD arm
              (the tiny transformer over {data: 1, fsdp: ranks} through
              train_from_dataset, a checkpoint a step, stopped after
              step SPMD_CKPT_PREEMPT and resumed by a fresh Executor:
              the uninterrupted run's losses and state bit for bit;
              writer ms and bytes a rank)
 30. seq      sequence parallelism (parallel/ring_attention.py,
              ulysses.py, models/bert.py sp_axis): the flash kernels at
              the ring's block shapes (q/k/v (32, 512/n, 12, 64): the
              blocks merged by their LSE against one launch over the
              keys, the diagonal block causal, a block's backward against
              the final O and LSE, the skipped blocks of a causal ring
              counted by its plan) and Ulysses' head groups ((32, 512,
              12/n, 64), key padding), and the FFN kernels on a sequence
              rank's tokens under the hash's row map, against their plain
              versions, timed there; then the spmd phase's ranks:
              BERT-base's sequence-parallel step over {dp: 1, sp: ranks}
              with ring attention (rows unpadded) and with Ulysses, full
              width, B=32, S=512, hidden dropout 0.1, SEQ_STEPS steps,
              each rank's launches counted, step ms, the bytes the ring
              and the all-to-alls move a step, the masters the same on
              every rank, the losses within SEQ_LOSS_RTOL and the masters
              within SEQ_MASTER_ATOL of rank 0's one-process step

The last two lines of stdout are a {"kernels": [...]} summary and the
{"ok": true, "device": {...}} result.

`python3 chip_smoke.py --ssd` runs only the card and ssd phases (no
kernel is built: none is on that path); `--ctr` the card and ctr phases;
`--feed` the card and feed phases; `--deploy` the card, build and deploy
phases; `--capi` the card, build and capi phases; `--dist` the card,
build and dist phases; `--spmd` the card, build and spmd phases;
`--seq` the card, build and seq phases.

`python3 chip_smoke.py --tensor-methods-ab` runs instead only the
host-bound decode, seq2seq and srl phases, in turns with the `matmul` /
`unsqueeze` extensions of fluid/dygraph/math_op_patch.py installed and
with torch's own methods back, then counts each phase's calls to the
two extensions and times one call of each form on the host.  Needs CUDA; imports nothing of JAX
and nothing of the JAX package.  TF32 is off for matmuls and cuDNN, so
every float32 product in the plain versions is a full float32 product.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import io as pio
from paddle_tpu_torch import metric as pmetric
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as poptim
from paddle_tpu_torch import profiler
from paddle_tpu_torch.ckpt import latest_checkpoint
from paddle_tpu_torch.fluid import unique_name
from paddle_tpu_torch.hapi import callbacks as hcb
from paddle_tpu_torch.nn import functional as pF
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.nn.layer.transformer import _dense_ffn_block
from paddle_tpu_torch.ops.kernels import COUNTERS, build
from paddle_tpu_torch.ops.kernels import attention as A
from paddle_tpu_torch.ops.kernels import ffn as F
from paddle_tpu_torch.ops.kernels import probe as P
from paddle_tpu_torch.serving import (AutoregressiveEngine, Engine,
                                      EngineConfig, LayeredDecoder,
                                      latency_stats, mean_occupancy,
                                      reset_latency)
from paddle_tpu_torch.tools import kernel4d_probe as K4
from paddle_tpu_torch.vision import models as VM
from paddle_tpu_torch.vision import train as VT

# the FFN switch as the package starts it (main() opens the kernel arm)
_FFN_DEFAULT = F._FFN_DISABLED

# published H100 SXM peaks (dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# bf16 outputs: kernel and plain version round the same f32 math to bf16
# after different summation orders (and the kernel rounds p to bf16 against
# the running max, the plain version against the final max): two bf16
# units in the last place
BF16_TOL = dict(atol=2 ** -6, rtol=2 ** -6)
# f32 log-sum-exp: summation order only
LSE_TOL = dict(atol=1e-4, rtol=1e-5)
# bf16 gradients are sums of products of bf16 tiles (p~, dS, h, dpre)
# whose f32 inputs differ in summation order, so a tile element may round
# the other way; a flip moves a sum by one bf16 unit of a TERM, and terms
# scale with the gradient's largest entries, not with an entry that
# cancels to near 0.  Each element within 2^-6 of the largest |entry|
# plus 2^-6 relative; the mean error within 2^-7 of the mean |entry|.
# GRAD_FLOOR: a gradient that is 0 in exact arithmetic (one key: dS =
# p (dP - delta) cancels) keeps the f32 rounding of dP - delta
GRAD_FRAC = 2 ** -6
GRAD_FLOOR = 2 ** -16
# |pre| under which relu's step may fall on either side (relu_slack)
RELU_KINK = 1e-4
# served response vs a direct forward of the same rows: the kernels are
# row-independent, but cuBLAS may pick other GEMM kernels for other batch
# sizes, and bf16 rounding differences then travel through 12 layers
SERVE_MAX_ABS = 0.25
SERVE_MEAN_ABS = 0.01
# bf16 on the card vs f32 on the CPU, 2 layers at base width
REF_MAX_ABS = 0.15
REF_MEAN_ABS = 0.02

# a decoded token's logit against the largest logit of a dense causal
# forward of its prefix: bf16 logits near 2 carry a unit of 2^-6 in the
# last place, and the engine (bucket-padded flash prefill, paged decode,
# other batch shapes in cuBLAS) rounds the hidden states at other places
# than the dense forward through 12 layers: 8 such units.  Random weights
# make near-ties common, so exact argmax agreement is printed, not held
DECODE_LOGIT_TOL = 0.125

SEQ = 512
LAYERS = 12  # BertConfig.base(): one launch of each kernel per layer
TRAIN_LR = 1e-4
FORWARD_KERNELS = ("flash_fwd", "ffn_fwd")
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "ffn_fwd",
                 "ffn_bwd_dw", "ffn_bwd_dx")
PROBE_KERNELS = ("probe_4d", "probe_fold3d", "probe_merged")
# the FFN's library arm: the element pass around its cuBLAS products
ACT_KERNELS = ("ffn_act_fwd", "ffn_act_bwd")
LIBRARY_TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
                         *ACT_KERNELS)
# the element pass against its plain version: both round an f32 value
# once to the operand's type (one unit in its last place), but act' takes
# the hardware's fast exp and reciprocal in the kernel (csrc/ffn_common.cuh),
# a few f32 units off the accurate form, which |pre| up to 8 and |dh| up
# to 4 scale to an absolute 1e-5 (measured on the card: 3.1e-6 at
# gelu_tanh), visible wherever dpre is small
ACT_TOL = {torch.bfloat16: dict(atol=1e-5, rtol=2 ** -7),
           torch.float32: dict(atol=1e-5, rtol=1e-5)}
# the tiny f32 BERT forward on the card against the CPU (TF32 off): f32
# summation order through 2 layers
COVERAGE_TOL = dict(atol=1e-4, rtol=1e-4)
# ResNet: bench_resnet50's chip configuration
# 50 timed steps: at lr 0.1 the loss of the one batch falls for two
# steps, then rises and swings until about step 25 before it falls
# steadily; where it swings depends on the algorithms cuDNN's search
# picked in this process, so the falling-loss check is read at step 51,
# past the swings (paddle_tpu's step rises too after its first fall, at
# a reduced size: tests/test_torch_resnet.py::
# test_bench_lr_loss_falls_then_rises)
RESNET_BATCH, RESNET_HW, RESNET_CLASSES, RESNET_STEPS = 128, 224, 1000, 50
RESNET_LR, RESNET_MOMENTUM = 0.1, 0.9
# resnet18 f32 on the card against the CPU: logits, loss and running
# statistics within RESNET_TOL (cuDNN sums the convolutions in other
# orders than the CPU: 1.0e-5 in the logits and 1.8e-6 in the running
# statistics on the H100, where the same step with TF32 on reads 7.0e-3
# and 8.2e-4, which do not pass); gradients by their relative L2 error,
# within
# RESNET_KINK: a ReLU input within f32 rounding of 0 takes the other
# side on one device and moves a whole term of a gradient sum
# (tests/test_torch_resnet.py measured up to 0.87 % on the CPU alone)
RESNET_TOL = dict(atol=1e-4, rtol=1e-4)
RESNET_KINK = 2e-2
# the static graph (phase 13): BASELINE.json configs[1] at its defaults,
# models/resnet.build_train_program(depth=50, class_num=1000, 224^2,
# batch 128): f32 as declared (TF32 off), Momentum lr 0.1, momentum 0.9,
# L2Decay 1e-4.  20 steps timed; the falling-loss check is read at step
# 31, past the swings of the one-batch curve at lr 0.1: from a first of
# 7.70 the f32 curve peaks at step 8 (7.92-8.51 on the H100) and falls
# to 2.61-3.25 at step 31 (two runs) and 2.59-3.45 at step 51 (four
# earlier runs; PERF.md §6)
FLUID_BATCH, FLUID_HW, FLUID_CLASSES = 128, 224, 1000
FLUID_TIMED, FLUID_STEPS = 20, 30
# float32 rates of one H100 SXM outside the tensor cores (the f32 program
# with TF32 off runs there)
PEAK_F32_FLOPS = 67e12
# resnet18 (width 8, B=8, 32 x 32) through the port's Executor on the
# card against its CPU Executor, each step from the CPU's state: the
# loss within FLUID_LOSS_RTOL (a forward of the same state in two
# summation orders), every float state var (parameters, velocities, BN
# running statistics) within RESNET_KINK in relative L2, elements under
# 1e-6 counted as 1e-6 (a ReLU kink flip moves a whole gradient term; a
# bias in front of a batch norm has an exact gradient of 0)
FLUID_LOSS_RTOL = 1e-4
# the fluid_amp phase: the fp16 LARS program's warm-up step, then AMP_TIMED
# steps timed and AMP_STEPS in all; at least AMP_MIN_APPLIED of them apply
# an update (the rest overflow while the scale falls from 32768)
AMP_TIMED, AMP_STEPS, AMP_MIN_APPLIED = 10, 40, 20
# recompute against the plain f32 step from one state: the loss (the same
# forward ops) and each parameter's update in relative L2 (the backward's
# sums in another order: a segment's autograd graph against per-op ones)
RECOMPUTE_LOSS_RTOL, RECOMPUTE_UPDATE_L2 = 1e-5, 1e-3
RECOMPUTE_STEPS = 3
# the optimizer zoo's steps, and the random rules' draws
ZOO_STEPS, RANDOM_DRAWS = 3, 10 ** 6
# the decorated cut resnet18, card against CPU: its steps (the first
# overflow at 32768 in fp16) and tests/test_torch_fluid_amp.py's fp16 loss
# tolerance (fp16's unit is 9.8e-4)
AMP_CUT_STEPS, AMP_CUT_LOSS = 5, dict(rtol=2e-3, atol=2e-4)
# MNIST (configs[0], Adam lr 1e-3) on one batch of 64
MNIST_BATCH, MNIST_STEPS = 64, 8
# the decode configuration: pages, slots, buckets (the pool is 12 x 513
# x 16 x 768 x 2 B x 2, about 303 MB)
PAGE_SIZE, NUM_PAGES, SLOTS, ROW_PAGES = 16, 513, 16, 32
PROMPT_BUCKETS, PREFILL_CHUNK = (64, 128, 256), 256
# token counts of the ffn_fwd sweep beside the decode step's 16
FWD_SWEEP = (64, 256, 512, 4096, 32 * SEQ)
TIMED_STEPS, PROFILED_STEPS = 32, 8
# the WMT Transformer (phase 14): BASELINE.json configs[2],
# TransformerConfig.base() (vocabularies of 30000, d_model 512, 8 heads of
# 64, 6 + 6 pre-norm layers, d_ff 2048, relu, dropout 0.1, label
# smoothing 0.1) trained at B=32, S=128 source and T=120 target tokens
# (about the 4096-token batch of Paddle's Transformer-base recipe; T != S,
# so cross-attention runs Sq != Sk); 1 warm-up and WMT_TIMED steps timed,
# the falling loss read at step WMT_STEPS.  The Noam warm-up is
# WMT_WARMUP steps, so the rate climbs from 4.4e-6 to 8.8e-4 (Noam's
# peak at the recipe's 4000 is 7.0e-4) and the fixed batch's loss falls
# within the phase; at 4000 the first 20 steps' rates stay under 4.5e-6
WMT_BATCH, WMT_SRC, WMT_TGT, WMT_HEADS, WMT_FF = 32, 128, 120, 8, 2048
WMT_LAYERS = 6  # a stack: 12 flash forwards a step (6 self + 6 cross)
WMT_TIMED, WMT_STEPS, WMT_WARMUP = 5, 20, 100
# decoding: 8 sources of 128 tokens, 32 steps (paddle_tpu's default
# max_len), greedy and beams of 4 (and 1, which must equal greedy)
WMT_DECODE_BATCH, WMT_BEAM, WMT_MAX_LEN = 8, 4, 32
# the 2.x front end (phase 15): hapi.Model.fit on BASELINE.json
# configs[1] (ResNet-50, 1000 classes) at B=128, 224^2, amp O1 on the
# static-mode adapter (bf16 over fp32 masters, the resnet phase's
# precision), over the port's DataLoader (4 process workers, the buffer
# reader) of HAPI_IMAGES synthetic uint8 images: one epoch, 16 steps
HAPI_IMAGES, HAPI_WORKERS, HAPI_EVAL_IMAGES = 2048, 4, 1024
HAPI_BOUNDARY, HAPI_LRS = 8, (0.1, 0.01)  # PiecewiseDecay, stepped by step
HAPI_WD = 1e-4
# the resnet18 fit on the card against the CPU (f32, TF32 off, Momentum
# lr 0.01, B=4 of 64 x 64).  One step: each parameter's and running
# statistic's change within RESNET_KINK in relative L2, as the resnet
# phase holds one step's gradients (a ReLU kink flip).  Three steps: the
# first loss (the same weights) within RESNET_TOL, each later one within
# RESNET_KINK of its distance from the first (on the H100: 0.0095 at step
# 3, 1.3 % of its 0.746).  After three steps the flips compound through
# the forwards (a change off by 8.6 % in relative L2 and 2.8e-3 in
# conv1.weight on the H100): logged, not held
# the loss of the first train_batch after Model.load against the same
# step of the model that was saved: the same weights, state and batch
# through the same (deterministic) forward algorithms
HAPI_RELOAD_RTOL = 1e-5
# the quickstart's LeNet (phase 16): the first step's loss and gradients
# on the card against the CPU, f32 with TF32 off
LENET_TOL = dict(atol=1e-5, rtol=1e-4)
# Paddle 2.x's seq2seq with attention (phase 17) at IWSLT'15 en-vi's
# sizes (tests/torch_seq2seq_program.IWSLT15: vocabularies of 17191 and
# 7709, 512 wide, 2 LSTM layers, B=128, T=50, f32): S2S_STEPS Model.fit
# steps on one staged batch, the loss read at the last against the first
# (S2S_FALL: it must have fallen by 1 % at least)
S2S_STEPS, S2S_FALL = 30, 0.99
# the encoder's cuDNN LSTM against its plain loop (f32, TF32 off, 2
# layers of 50 steps): y, h and c within S2S_LSTM_TOL (two summation
# orders of 512- and 1024-term products, through 50 steps of a
# contracting recurrence), each gradient within S2S_LSTM_GRAD of its
# tensor's largest element
S2S_LSTM_TOL = dict(atol=1e-4, rtol=1e-3)
S2S_LSTM_GRAD = 1e-3
# decoding: the batch's 128 sources at beam 10 for up to 50 steps; each
# beam's score against a teacher-forced pass of its tokens (the same f32
# sums of clamped log-probabilities, up to 50 terms of about -9, whose
# rows lie elsewhere in the products)
S2S_BEAM, S2S_MAX_LEN = 10, 50
S2S_SCORE_TOL = dict(atol=1e-3, rtol=1e-4)
# the static decode program (phase 21) on the card against the CPU
# Executor at this many of the batch's sources
STATIC_CUT = 8
# the book's semantic-role-labelling program (phase 18,
# tests/torch_srl_program.BOOK: db_lstm of depth 8, 512 wide, CoNLL-05's
# 44068 / 3162 / 106 vocabularies, B=10, T=64, f32) through
# fluid.Executor: SRL_STEPS SGD steps on one staged batch, the loss read
# at the last against the first (it must fall); then crf_decoding
SRL_STEPS = 30
# the card's Executor against the CPU's from the same state, each step
# from the CPU's (as _fluid_cpu_check): db_lstm at depth 2 and 32 wide
# for 3 steps, and the three other book programs at their test sizes
# for BOOK_STEPS, each step's loss within SRL_LOSS_RTOL (float32 with
# TF32 off: two summation orders), every float state var within
# SRL_STATE_TOL in relative L2, the decoded paths equal on the live
# positions
SRL_LOSS_RTOL, SRL_STATE_TOL, BOOK_STEPS = 1e-4, 1e-4, 5
# PaddleCV's MobileNet-SSD (phase 23, tests/torch_ssd_program.FULL: 300^2,
# 21 classes, 1917 priors, B=64, RMSProp lr 0.001 over piecewise_decay,
# L2Decay 5e-5, f32 with TF32 off) through fluid.Executor: 1 warm-up and
# SSD_TIMED steps timed, SSD_STEPS in all, the loss read at the last
# against the first (the one batch is learned); the quantization-aware
# program: 1 warm-up and SSD_QAT_STEPS timed
SSD_TIMED, SSD_STEPS, SSD_QAT_STEPS = 10, 12, 6
# the cut program (tests/torch_ssd_program.SMALL) on the card against the
# CPU Executor, each step from the CPU's state, as tests/test_torch_ssd.py
# holds it against paddle_tpu: the 1x1 maps' batch norms multiply the
# float32 rounding, and RMSProp's first step is sign-like, so an element
# whose gradient is within rounding of 0 may step either way; the
# updates and moments are held as one vector each (measured on the CPU
# against paddle_tpu: loss 5.4e-7, updates 8.3e-3, moments 7.8e-3, other
# state 1.2e-5); the loss at 1e-4 for two devices' summation orders
SSD_CUT_STEPS = 3
SSD_LOSS_RTOL, SSD_UPDATE, SSD_MOMENT, SSD_STATE = 1e-4, 5e-2, 5e-2, 1e-4
# the cut QAT program: level flips (tests/test_torch_slim.py)
QAT_LOSS_RTOL, QAT_SCALE = 2e-2, 0.3
# decoded scores and boxes on the card against the CPU: float32 softmax
# and box arithmetic in other orders; on the full width's heads two
# candidates whose scores are within SSD_TIE_ULPS times the devices'
# largest softmax difference are a tie, which may trade places
SSD_DET_TOL = dict(atol=1e-5, rtol=1e-4)
SSD_TIE_ULPS = 4
# each detection and quantize rule's case (tests/torch_det_cases.py) on the
# card against the CPU in float32
DET_RULE_TOL = dict(atol=1e-5, rtol=1e-4)
# the lstm rule's fused arm (one torch.lstm, cuDNN) against its loop at
# the book SRL test's default activations, (B, T, 4H) = (10, 64, 512):
# Hidden and Cell within SRL_ARM_TOL (64 steps of a contracting
# recurrence, two orders of 128-term products), each gradient within
# S2S_LSTM_GRAD of its tensor's largest element
SRL_ARM_TOL = dict(atol=1e-4, rtol=1e-3)
# PaddleRec's CTR-DNN (tests/torch_ctr_program.py) at FULL through the
# dataset path: CTR_FILES training files of CTR_LINES lines (100 000
# samples: 100 steps at B=1000) loaded with CTR_THREADS parser threads
# and shuffled from CTR_SEED; a warm-up pass over a file of
# CTR_WARM_LINES lines (10 steps), which the QueueDataset, compiled-
# program, NaN and profile checks read too; CTR_HELD_LINES held-out lines
# for inference
CTR_FILES, CTR_LINES, CTR_WARM_LINES, CTR_HELD_LINES = 8, 12500, 10000, 10000
CTR_THREADS, CTR_SEED = 4, 7
# a QueueDataset pass against an unshuffled InMemoryDataset pass over the
# same file from the same weights, on the card: the same ops on the same
# batches in the same order; each loss within
CTR_QUEUE_RTOL = 1e-6
# the inference model in a fresh scope against the trained scope's
# pruned forward over the held-out file: each prediction within
CTR_INFER_RTOL = 1e-6
# SMALL (3 files of 40 lines, B=32) trained by train_from_dataset on the
# card against the CPU Executor from the same weights over the same
# shuffled files, float32 sums in other orders: each loss within
# CTR_LOSS_RTOL, the parameters' updates and Adam's moments as one vector
# each within CTR_UPDATE (Adam's first steps are sign-like; the CPU
# against paddle_tpu measured 8.4e-6 and 1.1e-7 in
# tests/test_torch_ctr.py), the auc histograms equal
CTR_LOSS_RTOL, CTR_UPDATE = 1e-5, 1e-3
# the planted NaN: a dense value of this batch of the warm-up file
CTR_NAN_BATCH = 2
MEASURED = {}  # numbers one phase hands a later one
FAILURES = []


def log(*a):
    print(*a, flush=True)


def phase(name):
    def wrap(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            log(f"== {name}")
            try:
                out = fn(*a, **kw)
                log(f"-- {name} ok in {time.perf_counter() - t0:.1f} s")
                return out
            except Exception:  # noqa: BLE001 - reported, then exit 1
                FAILURES.append(name)
                report = f"-- {name} FAILED\n{traceback.format_exc()}"
                log(report)
                # stderr too, where a caller that keeps only the end of
                # stderr still reads why the run failed
                print(report, file=sys.stderr, flush=True)
                return None
        return run
    return wrap


def time_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def time_cycle(fn, args, rounds=4, graph=True):
    """ms of one fn(a) call, cycling through `args` in turn: the 12
    layers' weights or KV pools, whose working set is past the 50 MB L2
    as in a decode step, where each layer finds its own operands cold.
    With `graph`, one cycle is captured in a CUDA graph and replayed
    (the least of `rounds` replays, `K4.graphs_ms`), so the time is the
    device's alone: at the decode shapes a kernel is shorter than the
    host's dispatch of its Python wrapper, and timing the eager loop
    would time the host."""
    run = lambda: [fn(a) for a in args]
    if graph:
        return K4.graphs_ms({0: run}, len(args), replays=rounds)[0]
    run()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(rounds):
        run()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (rounds * len(args))


def close(got, want, atol, rtol):
    """(ok, max abs err) of |got - want| <= atol + rtol * |want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (err <= atol + rtol * want.abs()).all())
    return ok, float(err.max())


def close_grad(got, want, slack=0.0):
    """(ok, max abs err) under the GRAD_FRAC rule above, after `slack`
    (relu_slack) is taken off each element's error."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    over = (err - slack).clamp(min=0.0)
    ok = (bool(torch.isfinite(got).all())
          and bool((over <= GRAD_FRAC * float(want.abs().max())
                    + GRAD_FRAC * want.abs() + GRAD_FLOOR).all())
          and float(over.mean()) <= GRAD_FRAC / 2 * float(want.abs().mean())
          + GRAD_FLOOR)
    return ok, float(err.max())


def relu_slack(x, w1, b1, w2, g, seed, p):
    """What relu's step may move the FFN gradients by.  relu' jumps at
    pre = 0, and the kernels and the plain version sum pre's products in
    other f32 orders (about 1e-6 apart), so an element with |pre| under
    RELU_KINK may take the other side of the step in one of them: dpre
    there is either 0 or the (dropped, scaled) dh.  The bounds: dx by
    amb @ |W1|^T, dW1 by |x|^T @ amb, db1 by the column sums of amb, where
    amb = |dh| on those elements and 0 elsewhere (h = relu(pre) is
    continuous there, so dW2 and db2 do not move)."""
    t, f = x.shape[0], w1.shape[1]
    pre = x.float() @ w1.float() + b1.float()
    dh = g.float() @ w2.float().t()
    if p > 0.0:
        keep = F._ffn_keep(seed, 0, 0, t, f, p, device=x.device)
        dh = torch.where(keep, dh / (1.0 - p), torch.zeros_like(dh))
    amb = torch.where(pre.abs() < RELU_KINK, dh.abs(), torch.zeros_like(dh))
    return dict(dx=amb @ w1.float().abs().t(),
                dw1=x.float().abs().t() @ amb, db1=amb.sum(0),
                elements=int((pre.abs() < RELU_KINK).sum()))


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30)
    return smi.stdout.strip().splitlines()[0]


@phase("card")
def card():
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")


@phase("build")
def build_kernels():
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s wall, per source "
        f"{ {k: round(v, 1) for k, v in built.items()} }")
    for stem, text in build.BUILD_LOG.items():
        for fn, regs, spill in _ptxas_entries(text):
            log(f"ptxas {stem}: {fn}: {regs}; {spill}")
        notes = {ln.split(")")[0] + ")" for ln in text.splitlines()
                 if "Potential Performance Loss" in ln}
        if notes:
            log(f"ptxas {stem}: performance notes {sorted(notes)}")


def _ptxas_entries(text):
    """(kernel, registers line, spill line) for each entry function in
    ptxas's -v report."""
    out, fn, spill = [], None, ""
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
            for name in ("flash_fwd_kernel", "ffn_bwd_dpre_kernel",
                         "ffn_bwd_dx_kernel", "ffn_bwd_dw_kernel",
                         "ffn_fwd_kernel", "flash_bwd_dkv_kernel",
                         "flash_bwd_dq_kernel", "ragged_split_kernel",
                         "ragged_merge_kernel", "ragged_tiled_kernel",
                         "probe_kernel", "reduce_kernel"):
                if name in fn:
                    # the template arguments of the mangled name:
                    # ...kernelILi64ELb0EEEv... -> kernel<64,0>
                    rest = fn.split(name, 1)[1]
                    args = rest[1:].split("EEv", 1)[0].rstrip("E") \
                        if rest.startswith("I") else ""
                    for a, b in (("Li", ""), ("Lb", ""), ("E", ",")):
                        args = args.replace(a, b)
                    fn = name + (f"<{args}>" if args else "")
                    break
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and fn is not None:
            out.append((fn, ln.split(":", 1)[1].strip(), spill))
            fn = None
    return out


def _rand(g, *shape, scale=1.0):
    return (torch.randn(*shape, generator=g) * scale).to(
        "cuda", torch.bfloat16)


def _padding_bias(g, b, s):
    lens = torch.randint(s // 2, s + 1, (b,), generator=g)
    bias = torch.where(torch.arange(s)[None, :] < lens[:, None], 0.0,
                       A.DEFAULT_MASK_VALUE)
    return bias.to("cuda", torch.float32)


@phase("kernels")
def kernels():
    g = torch.Generator().manual_seed(0)
    rows = []

    # -- flash forward ------------------------------------------------------
    h, d = 12, 64
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [  # (B, S, causal, dropout_p); B=1 causal: the decode prefills
        (8, SEQ, False, 0.0), (2, SEQ, True, 0.1), (2, 200, False, 0.0)] + [
        (1, tb, True, 0.0) for tb in PROMPT_BUCKETS] + [
        # B*H edges under the plan: 128-query CTAs whose second warpgroup
        # lies past Sq, one query, a prefill with dropout
        (11, 130, False, 0.1), (11, 130, True, 0.0), (24, 300, True, 0.0),
        (1, 1, False, 0.0), (1, 200, True, 0.1)] + [
        (32, SEQ, False, 0.0)]
    worst = 0.0
    for b, s, causal, p in cases:
        q, k, v = (_rand(g, b, s, h, d) for _ in range(3))
        bias = _padding_bias(g, b, s)
        out, lse = A.flash_forward(q, k, v, bias, 1234, causal, None, None,
                                   p)
        again = A.flash_forward(q, k, v, bias, 1234, causal, None, None, p)
        torch.cuda.synchronize()
        ref_out, ref_lse = A.flash_forward_reference(q, k, v, bias, 1234,
                                                     causal, None, None, p)
        ok_o, err_o = close(out, ref_out, **BF16_TOL)
        ok_l, err_l = close(lse, ref_lse, **LSE_TOL)
        same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
        worst = max(worst, err_o)
        block_q, _, ctas = A._flash_plan(b, h, s, s, d, sms)
        log(f"flash_fwd B={b} S={s} causal={causal} p={p} (plan: {block_q} "
            f"queries a CTA, {ctas} CTAs): O err {err_o:.3g} LSE err "
            f"{err_l:.3g}, same bits twice {same} "
            f"{'ok' if ok_o and ok_l and same else 'MISMATCH'}")
        if not (ok_o and ok_l and same):
            raise AssertionError(f"flash_fwd disagrees with its plain "
                                 f"version at B={b} S={s}")
    # timing at the top bucket's shape (B=32, S=512), padding bias on: the
    # kernel and SDPA graph-timed in turns
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    keep = (bias == 0)[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = K4.graphs_ms({
        "kernel": lambda: [A.flash_forward(q, k, v, bias) for _ in range(4)],
        "sdpa": lambda: [sdpa(qt, kt, vt, attn_mask=keep) for _ in range(4)]},
        4)
    ms, library_ms = times["kernel"], times["sdpa"]
    plain_ms = time_ms(lambda: A.flash_forward_reference(q, k, v, bias),
                       iters=3, warmup=1)
    b, s = q.shape[0], q.shape[1]
    flops = 4 * b * h * s * s * d
    nbytes = 4 * b * s * h * d * 2 + b * s * 4 + b * h * s * 4
    bound_ms, bound_by = bound(flops, nbytes)
    block_q, block_k, ctas = A._flash_plan(b, h, s, s, d, sms)
    rows.append(dict(
        name="flash_fwd", route="cuda",
        source="paddle_tpu_torch/csrc/flash_fwd.cu",
        replaces="paddle_tpu/ops/pallas/attention.py:120",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
        shape=f"q/k/v ({b},{s},{h},{d}) bf16, key-padding bias",
        plan=dict(block_q=block_q, block_k=block_k, ctas=ctas),
        prefill=_flash_prefill_times(g, h, d, sms),
        flops=flops, bytes=nbytes, tolerance=BF16_TOL))
    del q, k, v, qt, kt, vt, out, ref_out, again

    # -- FFN forward ----------------------------------------------------------
    hid, ff = 768, 3072
    worst = 0.0
    # T = 64/128/256: the decode path's prefill buckets and chunks
    for t, p, act in [(8 * SEQ, 0.0, "gelu"), (8 * SEQ, 0.1, "gelu"),
                      (1000, 0.0, "relu")] + [
                      (tb, 0.0, "gelu") for tb in PROMPT_BUCKETS] + [
                      (32 * SEQ, 0.0, "gelu")]:
        x = _rand(g, t, hid)
        w1, b1 = _rand(g, hid, ff, scale=0.03), _rand(g, ff, scale=0.1)
        w2, b2 = _rand(g, ff, hid, scale=0.03), _rand(g, hid, scale=0.1)
        out = F.ffn_forward(x, w1, b1, w2, b2, act, p, 99)
        torch.cuda.synchronize()
        ref = F.ffn_forward_reference(x, w1, b1, w2, b2, act, p, 99)
        ok, err = close(out, ref, **BF16_TOL)
        worst = max(worst, err)
        log(f"ffn_fwd T={t} act={act} p={p}: err {err:.3g} "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"ffn_fwd disagrees with its plain version "
                                 f"at T={t}")
    ms = time_ms(lambda: F.ffn_forward(x, w1, b1, w2, b2))
    plain_ms = time_ms(lambda: F.ffn_forward_reference(x, w1, b1, w2, b2),
                       iters=3, warmup=1)
    library_ms = time_ms(lambda: torch.addmm(
        b2, torch.nn.functional.gelu(torch.addmm(b1, x, w1)), w2))
    t = x.shape[0]
    flops = 4 * t * hid * ff
    nbytes = (2 * t * hid + 2 * hid * ff + ff + hid) * 2
    bound_ms, bound_by = bound(flops, nbytes)
    rows.append(dict(
        name="ffn_fwd", route="cuda", source="paddle_tpu_torch/csrc/ffn_fwd.cu",
        replaces="paddle_tpu/ops/pallas/ffn.py:134", max_abs_err=worst,
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=library_ms,
        shape=f"x ({t},{hid}) W1 ({hid},{ff}) W2 ({ff},{hid}) bf16, gelu",
        flops=flops, bytes=nbytes, tolerance=BF16_TOL))
    rows[-1].update(_ffn_decode_shape(g, hid, ff))
    del x, w1, b1, w2, b2, out, ref
    rows[-1]["sweep"] = _ffn_fwd_sweep(g, hid, ff, rows[-1])
    torch.cuda.empty_cache()
    rows.append(_ragged_row(g))
    torch.cuda.empty_cache()
    rows += _flash_backward_rows(g)
    torch.cuda.empty_cache()
    rows += _ffn_backward_rows(g)
    torch.cuda.empty_cache()
    rows += _ffn_act_rows(g)
    torch.cuda.empty_cache()
    _wmt_kernel_holds(g, {r["name"]: r for r in rows})
    torch.cuda.empty_cache()
    for r in rows:
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f}"
        log(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
            f"library {lib}, bound {r['bound_ms']:.4f} "
            f"{r['bound_by']}) at {r['shape']}")
    return rows


def _flash_prefill_times(g, h, d, sms):
    """flash_fwd at the decode path's single-shot prefill shapes (one
    sequence of 64, 128 or 256 tokens, causal), graph-timed in turns with
    SDPA, beside the plan and the bound."""
    points = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for s in PROMPT_BUCKETS:
        q, k, v = (_rand(g, 1, s, h, d) for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        times = K4.graphs_ms({
            "kernel": lambda: [A.flash_forward(q, k, v, None, 0, True)
                               for _ in range(8)],
            "sdpa": lambda: [sdpa(qt, kt, vt, is_causal=True)
                             for _ in range(8)]}, 8)
        bound_ms, bound_by = bound(2 * h * s * (s + 1) * d,
                                   4 * s * h * d * 2 + h * s * 4)
        block_q, _, ctas = A._flash_plan(1, h, s, s, d, sms)
        points.append(dict(s=s, ms=times["kernel"], library_ms=times["sdpa"],
                           bound_ms=bound_ms, bound_by=bound_by,
                           block_q=block_q, ctas=ctas))
        log(f"flash_fwd prefill B=1 S={s} causal: {times['kernel']:.4f} ms, "
            f"SDPA {times['sdpa']:.4f} ms, bound {bound_ms:.4f} {bound_by}; "
            f"{block_q} queries a CTA, {ctas} CTAs")
    return points


def _ffn_decode_shape(g, hid, ff):
    """ffn_fwd at the decode step's shape, 16 tokens, cycling through 12
    layers' weights (113 MB), beside the cuBLAS addmm -> gelu -> addmm
    arm at the same shape."""
    xs = _rand(g, SLOTS, hid)
    ws = [(_rand(g, hid, ff, scale=0.03), _rand(g, ff, scale=0.1),
           _rand(g, ff, hid, scale=0.03), _rand(g, hid, scale=0.1))
          for _ in range(LAYERS)]
    ok, err = close(F.ffn_forward(xs, *ws[0]),
                    F.ffn_forward_reference(xs, *ws[0]), **BF16_TOL)
    if not ok:
        raise AssertionError(f"ffn_fwd disagrees with its plain version at "
                             f"T={SLOTS} (err {err})")
    ms = time_cycle(lambda w: F.ffn_forward(xs, *w), ws)
    lib_ms = time_cycle(lambda w: torch.addmm(w[3], torch.nn.functional.gelu(
        torch.addmm(w[1], xs, w[0])), w[2]), ws)
    nbytes = (2 * SLOTS * hid + 2 * hid * ff + ff + hid) * 2
    bound_ms, bound_by = bound(4 * SLOTS * hid * ff, nbytes)
    log(f"ffn_fwd at T={SLOTS} (decode step), 12 layers' weights in turn: "
        f"{ms:.4f} ms, cuBLAS arm {lib_ms:.4f} ms, bound {bound_ms:.4f} "
        f"{bound_by}; err {err:.3g}")
    return dict(decode_t16_ms=ms, decode_t16_library_ms=lib_ms,
                decode_t16_bound_ms=bound_ms)


def _ffn_fwd_sweep(g, hid, ff, row):
    """ffn_fwd against the cuBLAS addmm -> gelu -> addmm arm over token
    counts: each point checked against the plain version, run twice for
    the same bits (the fixed-order split reduce), and graph-timed in turns
    with the arm, beside its bound and the kernel's plan (token tile,
    d_ff splits, column groups).  T=16 is the decode shape above, with 12
    layers' weights cycling cold."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    w1, b1 = _rand(g, hid, ff, scale=0.03), _rand(g, ff, scale=0.1)
    w2, b2 = _rand(g, ff, hid, scale=0.03), _rand(g, hid, scale=0.1)
    points = [dict(t=SLOTS, ms=row["decode_t16_ms"],
                   library_ms=row["decode_t16_library_ms"],
                   bound_ms=row["decode_t16_bound_ms"], bound_by="bytes",
                   weights_cold=True)]
    for t in FWD_SWEEP:
        x = _rand(g, t, hid)
        out = F.ffn_forward(x, w1, b1, w2, b2, "gelu", 0.1, 5)
        again = F.ffn_forward(x, w1, b1, w2, b2, "gelu", 0.1, 5)
        ok, err = close(out, F.ffn_forward_reference(
            x, w1, b1, w2, b2, "gelu", 0.1, 5), **BF16_TOL)
        if not ok or not torch.equal(out, again):
            raise AssertionError(f"ffn_fwd at T={t}: err {err}, same bits "
                                 f"in two runs: {torch.equal(out, again)}")
        calls = 8 if t <= 4096 else 2
        times = K4.graphs_ms({
            "kernel": lambda: [F.ffn_forward(x, w1, b1, w2, b2)
                               for _ in range(calls)],
            "arm": lambda: [torch.addmm(b2, torch.nn.functional.gelu(
                torch.addmm(b1, x, w1)), w2) for _ in range(calls)]}, calls)
        bound_ms, bound_by = bound(
            4 * t * hid * ff, (2 * t * hid + 2 * hid * ff + ff + hid) * 2)
        points.append(dict(t=t, ms=times["kernel"], library_ms=times["arm"],
                           bound_ms=bound_ms, bound_by=bound_by,
                           max_abs_err=err, weights_cold=False))
        del x, out, again
    for pt in points:
        block_t, n_split = F._fwd_plan(pt["t"], hid, ff, sms)
        pt["plan"] = dict(block_t=block_t, n_split=n_split,
                          col_groups=F._fwd_groups(hid))
        pt["ctas"] = (-(-pt["t"] // block_t) * n_split
                      * pt["plan"]["col_groups"])
        log(f"ffn_fwd sweep T={pt['t']}: {pt['ms']:.4f} ms, cuBLAS arm "
            f"{pt['library_ms']:.4f} ms, bound {pt['bound_ms']:.4f} "
            f"({pt['bound_by']}); plan {pt['plan']}, {pt['ctas']} CTAs"
            + (" (weights cycling cold)" if pt["weights_cold"] else ""))
    return points


def _paged_inputs(g, lengths, t, qpos0=None, h=12, d=64, s=PAGE_SIZE,
                  w=ROW_PAGES, layers=LAYERS):
    """A random page pool of `layers` layers, (L, P, S, H, D), or one
    (P, S, H, D) pool with layers=None (scratch page 0 included); page
    rows of `w` entries over a shuffled set of pages (each sequence its
    own, unused entries -> page 0); q; and the query positions: lengths
    - T .. lengths - 1, or qpos0 .. qpos0 + T - 1.  All on the card,
    rows/lengths/qpos int32.

    Also the work the function needs, for the bound: `kv_rows`, the K
    and V rows it must read (a lane reads its keys up to its last query
    position, capped at its length and row; a lane with no such key
    reads page 0's V alone, for the uniform softmax), and `flops`: 4 H D
    per (query, key <= qpos) pair, 2 H D S per query with no key."""
    b = len(lengths)
    need = [-(-n // s) for n in lengths]
    n_pages = 1 + sum(need)
    perm = (torch.randperm(n_pages - 1, generator=g) + 1).to(torch.int32)
    rows = torch.zeros(b, w, dtype=torch.int32)
    nxt = 0
    for i, n in enumerate(need):
        rows[i, :n] = perm[nxt:nxt + n]
        nxt += n
    lens = torch.tensor(lengths, dtype=torch.int32)
    ar = torch.arange(t, dtype=torch.int32)
    qpos = lens[:, None] - t + ar if qpos0 is None \
        else (qpos0 + ar).expand(b, t)
    cap = lens.clamp(max=w * s)[:, None]
    pairs = torch.minimum(qpos + 1, cap).clamp(min=0)  # (B, T) keys
    k_rows = int(pairs.max(1).values.sum())
    v_rows = k_rows + s * int((pairs.max(1).values == 0).sum())
    flops = (4 * h * d * int(pairs.sum())
             + 2 * h * d * s * int((pairs == 0).sum()))
    pool = (n_pages, s, h, d) if layers is None else (layers, n_pages, s, h, d)
    return dict(rows=rows.cuda(), lens=lens.cuda(), q=_rand(g, b, t, h, d),
                kc=_rand(g, *pool), vc=_rand(g, *pool),
                qpos=qpos.contiguous().cuda(), kv_rows=k_rows + v_rows,
                flops=flops)


def _ragged_case(c, name):
    """Check the kernel against its plain version on every lane (layers
    0 and 11; the same bits twice), then time kernel and the library
    yardstick (index_select of the pages, then SDPA with a bool mask),
    each cycling through the 12 layers' pools, graph-timed in turns; the
    plain version eager."""
    rows, lens, q, kc, vc, qpos = (c[k] for k in ("rows", "lens", "q", "kc",
                                                   "vc", "qpos"))
    b, t, h, d = q.shape
    s = kc.shape[2]
    scale = d ** -0.5
    plan = A._ragged_plan(b, t, h, d, s, rows.shape[1],
                          torch.cuda.get_device_properties(0)
                          .multi_processor_count)
    worst = 0.0
    for li in (0, LAYERS - 1):
        out = A.ragged_paged_forward(rows, lens, q, kc[li], vc[li], qpos,
                                     scale)
        again = A.ragged_paged_forward(rows, lens, q, kc[li], vc[li], qpos,
                                       scale)
        torch.cuda.synchronize()
        ref = A.ragged_paged_reference(rows, lens, q, kc[li], vc[li], qpos,
                                       scale)
        ok, err = close(out, ref, **BF16_TOL)
        worst = max(worst, err)
        if not ok or not torch.equal(out, again):
            raise AssertionError(f"ragged_paged disagrees with its plain "
                                 f"version at {name} (layer {li}, err {err}, "
                                 f"same bits twice {torch.equal(out, again)})")
    layers = range(LAYERS)
    pos = torch.arange(ROW_PAGES * s, device="cuda")
    flat = (rows.long()[:, pos // s] * s + pos % s).reshape(-1)
    keep = (pos[None, None, :] <= qpos.long()[:, :, None])[:, None]
    qt = q.transpose(1, 2)

    def library(li):
        k, v = (pool[li].view(-1, h, d).index_select(0, flat)
                .view(b, -1, h, d).transpose(1, 2) for pool in (kc, vc))
        return torch.nn.functional.scaled_dot_product_attention(
            qt, k, v, attn_mask=keep, scale=scale)

    times = K4.graphs_ms({
        "kernel": lambda: [A.ragged_paged_forward(
            rows, lens, q, kc[li], vc[li], qpos, scale) for li in layers],
        "library": lambda: [library(li) for li in layers]},
        LAYERS, replays=8)
    ms, library_ms = times["kernel"], times["library"]
    plain_ms = time_cycle(lambda li: A.ragged_paged_reference(
        rows, lens, q, kc[li], vc[li], qpos, scale), layers, rounds=1,
        graph=False)
    flops = c["flops"]
    nbytes = (c["kv_rows"] * h * d * 2 + 2 * b * t * h * d * 2
              + rows.numel() * 4 + b * 4 + b * t * 4)
    bound_ms, bound_by = bound(flops, nbytes)
    brief = {k: plan[k] for k in ("path", "pages_per_split", "splits",
                                  "head_groups", "heads_per_group", "grid",
                                  "ctas", "smem", "workspace")}
    log(f"ragged_paged {name}: err {worst:.3g} ok, same bits twice; "
        f"{ms:.4f} ms (library {library_ms:.4f} in the same turns, plain "
        f"{plain_ms:.4f}, bound {bound_ms:.4f} {bound_by}), "
        f"{c['kv_rows']} K and V rows needed; plan {brief}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, err=worst, flops=flops,
                bytes=nbytes, plan=brief)


def _paged_dense_arm(g, calls=3):
    """paged_attention on inputs the ragged kernel does not take (f32,
    head_dim 80, pages of 16): every call goes to the dense arm
    (`dense_paged_attention`, then `dense_attention`), is counted once as
    serving_ragged_fallback_total, launches no ragged kernel, and agrees
    with the kernel's plain version on the lanes inside their sequence
    (f32 against f32: summation order only)."""
    lengths = [0, 17, 100, 255]
    c = _paged_inputs(g, lengths, 1, h=4, d=80, layers=None)
    q, kp, vp = (c[k].float() for k in ("q", "kc", "vc"))
    before = profiler.get_int_stats()
    ragged0 = COUNTERS["ragged_paged"].value
    outs = [A.paged_attention(q, kp, vp, c["rows"], c["lens"])
            for _ in range(calls)]
    torch.cuda.synchronize()
    after = profiler.get_int_stats()
    fell = after.get("serving_ragged_fallback_total", 0) \
        - before.get("serving_ragged_fallback_total", 0)
    dense = after.get("attention_dispatch_dense", 0) \
        - before.get("attention_dispatch_dense", 0)
    if fell != calls or dense != calls \
            or COUNTERS["ragged_paged"].value != ragged0:
        raise AssertionError(f"dense paged arm: {fell} fallbacks and "
                             f"{dense} dense attentions counted in {calls} "
                             f"calls, ragged launches "
                             f"{COUNTERS['ragged_paged'].value - ragged0}")
    qpos = c["lens"].long()[:, None] - 1
    ref = A.ragged_paged_reference(c["rows"], c["lens"], q, kp, vp, qpos,
                                   80 ** -0.5)
    valid = c["lens"] > 0
    ok, err = close(outs[0][valid], ref[valid], atol=1e-5, rtol=1e-5)
    if not ok or not all(torch.equal(o, outs[0]) for o in outs):
        raise AssertionError(f"dense paged arm disagrees with the plain "
                             f"version: {err}")
    log(f"paged_attention f32 D=80 (not the ragged kernel's): {calls} calls"
        f", {fell} counted fallbacks, {dense} dense attentions, 0 ragged "
        f"launches; err {err:.3g} against the plain version")
    return dict(calls=calls, fallbacks=fell, max_abs_err=err,
                shape="q (4,1,4,80) f32, pages (P,16,4,80), lengths "
                      f"{lengths}")


def _ragged_row(g):
    """The ragged paged-attention kernel at the decode path's two shapes,
    one for each of its paths: (a) a decode step (the split path), B=16,
    T=1, ragged lengths over 1-511 with one length-0 lane and one exact
    page multiple; (b) a chunk step (the tiled path), B=1, T=256, query
    positions 256..511 over length 512.  12 heads of 64, pages of 16,
    rows of 32 pages.  `workspace_bytes`: the split path's f32 partials
    at (a), allocated at each call."""
    lengths = [0, 256] + sorted(
        torch.randint(1, 512, (SLOTS - 2,), generator=g).tolist())
    a = _ragged_case(_paged_inputs(g, lengths, 1), "(a) decode B=16 T=1")
    torch.cuda.empty_cache()
    bc = _ragged_case(_paged_inputs(g, [512], 256, qpos0=256),
                      "(b) chunk B=1 T=256")
    return dict(
        name="ragged_paged", route="cuda",
        source="paddle_tpu_torch/csrc/ragged_paged.cu",
        replaces="paddle_tpu/ops/pallas/attention.py:895",
        max_abs_err=max(a["err"], bc["err"]), ms=a["ms"],
        plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
        bound_by=a["bound_by"], library_ms=a["library_ms"],
        shape=f"(a) q (16,1,12,64), pools (P,16,12,64) bf16, lengths "
              f"{lengths}, W=32",
        flops=a["flops"], bytes=a["bytes"],
        chunk_shape="(b) q (1,256,12,64), qpos 256..511, length 512",
        chunk_ms=bc["ms"], chunk_plain_ms=bc["plain_ms"],
        chunk_library_ms=bc["library_ms"], chunk_bound_ms=bc["bound_ms"],
        chunk_bound_by=bc["bound_by"], plan=a["plan"], chunk_plan=bc["plan"],
        workspace_bytes=4 * a["plan"]["workspace"], tolerance=BF16_TOL,
        dense_arm=_paged_dense_arm(g))


def _flash_backward_rows(g):
    """The dkv and dq kernels against their plain version (which computes
    dq, dk and dv together), then graph-timed in turns with SDPA's
    backward at the path's shape: B=32, S=512, 12 heads of 64, key
    padding, attention dropout 0.1 (and 0, as SDPA's backward runs)."""
    h, d, seed = 12, 64, 4321
    worst = {"dkv": 0.0, "dq": 0.0}
    for b, s, causal, p in [(8, SEQ, False, 0.1), (2, SEQ, True, 0.1),
                            (2, 200, False, 0.0), (32, SEQ, False, 0.1)]:
        q, k, v, gr = (_rand(g, b, s, h, d) for _ in range(4))
        bias = _padding_bias(g, b, s)
        out, lse = A.flash_forward(q, k, v, bias, seed, causal, None, None,
                                   p)
        dq, dk, dv = A.flash_backward(q, k, v, bias, seed, out, lse, gr,
                                      causal, None, None, p)
        torch.cuda.synchronize()
        rq, rk, rv = A.flash_backward_reference(q, k, v, bias, seed, out,
                                                lse, gr, causal, None, None,
                                                p)
        checks = {"dq": close_grad(dq, rq), "dk": close_grad(dk, rk),
                  "dv": close_grad(dv, rv)}
        worst["dq"] = max(worst["dq"], checks["dq"][1])
        worst["dkv"] = max(worst["dkv"], checks["dk"][1], checks["dv"][1])
        ok = all(c[0] for c in checks.values())
        log(f"flash_bwd B={b} S={s} causal={causal} p={p}: "
            + " ".join(f"{n} err {c[1]:.3g}" for n, c in checks.items())
            + (" ok" if ok else " MISMATCH"))
        if not ok:
            raise AssertionError(f"flash_bwd disagrees with its plain "
                                 f"version at B={b} S={s}")
        del dq, dk, dv, rq, rk, rv
    # timing at the last case's shape (B=32, S=512): each kernel graph-
    # timed in turns with SDPA's backward, at the path's dropout 0.1 and
    # at dropout 0 (SDPA's backward has no dropout).  The yardstick, with a
    # bool key mask, is (forward + backward) - forward, both captured too:
    # an eager loop would time the host's dispatch
    scale = d ** -0.5
    arms = {}
    for p in (0.1, 0.0):
        _, launch_dkv, launch_dq = A._flash_bwd_launchers(
            q, k, v, bias, seed, out, lse, gr, False, 0, scale, p)
        arms[f"dkv p={p}"] = launch_dkv
        arms[f"dq p={p}"] = launch_dq
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    gt = gr.transpose(1, 2)
    keep = (bias == 0)[:, None, None, :]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=keep)
    arms["sdpa forward"] = sdpa
    arms["sdpa forward+backward"] = lambda: torch.autograd.grad(
        sdpa(), (qt, kt, vt), gt)
    times = K4.graphs_ms({key: (lambda fn=fn: [fn() for _ in range(2)])
                          for key, fn in arms.items()}, 2)
    library_ms = times["sdpa forward+backward"] - times["sdpa forward"]
    log("flash_bwd graph-timed, ms a call: "
        + ", ".join(f"{key} {ms:.4f}" for key, ms in times.items())
        + f"; SDPA backward {library_ms:.4f}")
    plain_ms = time_ms(lambda: A.flash_backward_reference(
        q, k, v, bias, seed, out, lse, gr, False, 0, scale, 0.1), iters=2,
        warmup=1)
    b, s = q.shape[0], q.shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    qkv_bytes = b * s * h * d * 2
    rows_bytes = 2 * b * h * s * 4 + b * s * 4  # lse, delta; key bias
    product = 2 * b * h * s * s * d
    rows = []
    for name, arm, n_products, n_out, err, line in (
            ("flash_bwd_dkv", "dkv", 4, 2, worst["dkv"], "263"),
            ("flash_bwd_dq", "dq", 3, 1, worst["dq"], "331")):
        ms = times[f"{arm} p=0.1"]
        flops = n_products * product
        nbytes = (4 + n_out) * qkv_bytes + rows_bytes
        bound_ms, bound_by = bound(flops, nbytes)
        rows.append(dict(
            name=name, route="cuda",
            source="paddle_tpu_torch/csrc/flash_bwd.cu",
            replaces=f"paddle_tpu/ops/pallas/attention.py:{line}",
            max_abs_err=err, ms=ms, ms_dropout0=times[f"{arm} p=0.0"],
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms,
            plain_and_library_cover="dq, dk and dv together; the library "
                                    "call at dropout 0",
            plan=A._flash_bwd_plan(b, h, s, s, d, sms),
            shape=f"q/k/v/g ({b},{s},{h},{d}) bf16, key-padding bias, "
                  f"dropout 0.1", flops=flops, bytes=nbytes,
            tolerance=f"GRAD_FRAC {GRAD_FRAC}"))
    return rows


def _ffn_backward_rows(g):
    """The dW and dx kernels against their plain version (which computes
    every gradient together), then timed at the path's shape: 32 x 512
    tokens, d_model 768, d_ff 3072, gelu, hidden dropout 0.1."""
    hid, ff, seed = 768, 3072, 99
    worst = {"dw": 0.0, "dx": 0.0}
    for t, p, act in [(8 * SEQ, 0.1, "gelu"), (1000, 0.0, "relu"),
                      (32 * SEQ, 0.1, "gelu")]:
        x, gr = _rand(g, t, hid), _rand(g, t, hid)
        w1, b1 = _rand(g, hid, ff, scale=0.03), _rand(g, ff, scale=0.1)
        w2, b2 = _rand(g, ff, hid, scale=0.03), _rand(g, hid, scale=0.1)
        got = F.ffn_backward(x, w1, b1, w2, b2, seed, gr, act, p)
        torch.cuda.synchronize()
        want = F.ffn_backward_reference(x, w1, b1, w2, b2, seed, gr, act, p)
        slack = (relu_slack(x, w1, b1, w2, gr, seed, p) if act == "relu"
                 else {})
        checks = {n: close_grad(a, w, slack.get(n, 0.0)) for n, a, w in
                  zip(("dx", "dw1", "db1", "dw2", "db2"), got, want)}
        worst["dx"] = max(worst["dx"], checks["dx"][1])
        worst["dw"] = max(worst["dw"], *(checks[n][1]
                                         for n in ("dw1", "db1", "dw2")))
        ok = all(c[0] for c in checks.values())
        log(f"ffn_bwd T={t} act={act} p={p}: "
            + " ".join(f"{n} err {c[1]:.3g}" for n, c in checks.items())
            + (f"; {slack['elements']} pre within {RELU_KINK} of relu's "
               f"step" if slack else "") + (" ok" if ok else " MISMATCH"))
        if not ok:
            raise AssertionError(f"ffn_bwd disagrees with its plain version "
                                 f"at T={t}")
        del got, want
    _, launch_dw, launch_dx = F._ffn_bwd_launchers(
        x, w1, b1, w2, b2, seed, gr, "gelu", 0.1)
    dw_ms = time_ms(launch_dw)
    plain_ms = time_ms(lambda: F.ffn_backward_reference(
        x, w1, b1, w2, b2, seed, gr, "gelu", 0.1), iters=2, warmup=1)
    # the library yardsticks: the cuBLAS addmm -> gelu -> addmm arm's
    # backward (no dropout).  Whole: (forward + backward) - forward, both
    # by CUDA graph replay.  Each kernel's own: the arm's calls that
    # compute that kernel's outputs (dW: pre, h, dh, dpre, dW1, dW2, db1;
    # dx: pre, dh, dpre, dx), graph-timed in turns
    leaves = [a.detach().requires_grad_() for a in (x, w1, b1, w2, b2)]
    arm = lambda _: torch.addmm(leaves[4], torch.nn.functional.gelu(
        torch.addmm(leaves[2], leaves[0], leaves[1])), leaves[3])
    fwd_ms = time_cycle(arm, range(2))
    both_ms = time_cycle(
        lambda _: torch.autograd.grad(arm(_), leaves, gr), range(2))
    whole_ms = both_ms - fwd_ms
    gelu_bw = torch.ops.aten.gelu_backward

    def dw_arm():
        pre = torch.addmm(b1, x, w1)
        h = torch.nn.functional.gelu(pre)
        dpre = gelu_bw(gr @ w2.t(), pre)
        return x.t() @ dpre, h.t() @ gr, dpre.sum(0)

    def dx_arm():
        pre = torch.addmm(b1, x, w1)
        return gelu_bw(gr @ w2.t(), pre) @ w1.t()

    # dx (two launches: dpre, then the GEMM) in turns with the arms
    own_ms = K4.graphs_ms({"kernel_dx": lambda: [launch_dx()
                                                 for _ in range(2)],
                           "ffn_bwd_dx": lambda: [dx_arm() for _ in range(2)],
                           "ffn_bwd_dw": lambda: [dw_arm() for _ in range(2)]},
                          2)
    dx_ms = own_ms["kernel_dx"]
    t = x.shape[0]
    product = 2 * t * hid * ff
    act_bytes = t * hid * 2          # x, g or dx
    weight_bytes = hid * ff * 2      # w1, w2, dw1 or dw2
    rows = []
    for name, ms, n_products, nbytes, err, line in (
            ("ffn_bwd_dw", dw_ms, 4,
             2 * act_bytes + 4 * weight_bytes + 2 * ff * 2, worst["dw"],
             "192"),
            ("ffn_bwd_dx", dx_ms, 3,
             3 * act_bytes + 2 * weight_bytes + ff * 2, worst["dx"],
             "231")):
        flops = n_products * product
        bound_ms, bound_by = bound(flops, nbytes)
        rows.append(dict(
            name=name, route="cuda", source="paddle_tpu_torch/csrc/ffn_bwd.cu",
            replaces=f"paddle_tpu/ops/pallas/ffn.py:{line}",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=own_ms[name],
            library_whole_backward_ms=whole_ms,
            plain_covers="dx, dW1, db1, dW2 and db2 together",
            shape=f"x/g ({t},{hid}) W1 ({hid},{ff}) W2 ({ff},{hid}) bf16, "
                  f"gelu, dropout 0.1", flops=flops, bytes=nbytes,
            tolerance=f"GRAD_FRAC {GRAD_FRAC}"))
    plan = F._dx_plan(t, hid, ff)
    rows[-1].update(workspace_bytes=plan["workspace_bytes"], plan=plan,
                    sweep=_ffn_bwd_dx_sweep(g))
    rows[-2]["d_model_1024"], rows[-1]["d_model_1024"] = _ffn_bwd_large(g)
    return rows


def _ffn_bwd_large(g):
    """Both FFN backward kernels at BERT-large's widths (d_model 1024,
    d_ff 4096, 32 x 512 tokens, gelu, dropout 0.1): checked against the
    plain version, then dW timed by CUDA events and dx graph-timed in
    turns with the cuBLAS arm's dx calls."""
    hid, ff, t, seed = 1024, 4096, 32 * SEQ, 31
    x, gr = _rand(g, t, hid), _rand(g, t, hid)
    w1, b1 = _rand(g, hid, ff, scale=0.03), _rand(g, ff, scale=0.1)
    w2, b2 = _rand(g, ff, hid, scale=0.03), _rand(g, hid, scale=0.1)
    got = F.ffn_backward(x, w1, b1, w2, b2, seed, gr, "gelu", 0.1)
    want = F.ffn_backward_reference(x, w1, b1, w2, b2, seed, gr, "gelu", 0.1)
    checks = {n: close_grad(a, w) for n, a, w in
              zip(("dx", "dw1", "db1", "dw2", "db2"), got, want)}
    if not all(c[0] for c in checks.values()):
        raise AssertionError(f"ffn_bwd at d_model 1024 disagrees: {checks}")
    del got, want
    _, launch_dw, launch_dx = F._ffn_bwd_launchers(
        x, w1, b1, w2, b2, seed, gr, "gelu", 0.1)
    dw_ms = time_ms(launch_dw)
    gelu_bw = torch.ops.aten.gelu_backward
    times = K4.graphs_ms({
        "kernel": lambda: [launch_dx() for _ in range(2)],
        "arm": lambda: [gelu_bw(gr @ w2.t(), torch.addmm(b1, x, w1)) @ w1.t()
                        for _ in range(2)]}, 2)
    product, act, weight = 2 * t * hid * ff, t * hid * 2, hid * ff * 2
    out = []
    for name, ms, n_products, nbytes, lib in (
            ("ffn_bwd_dw", dw_ms, 4, 2 * act + 4 * weight, None),
            ("ffn_bwd_dx", times["kernel"], 3, 3 * act + 2 * weight,
             times["arm"])):
        bound_ms, bound_by = bound(n_products * product, nbytes)
        out.append(dict(ms=ms, library_ms=lib, bound_ms=bound_ms,
                        bound_by=bound_by, max_abs_err=max(
                            checks[n][1] for n in (("dw1", "db1", "dw2")
                                                   if name == "ffn_bwd_dw"
                                                   else ("dx",)))))
        log(f"{name} at d_model 1024, d_ff 4096, T={t}: {ms:.4f} ms"
            + (f", cuBLAS arm {lib:.4f} ms" if lib else "")
            + f", bound {bound_ms:.4f} {bound_by}; agrees")
    torch.cuda.empty_cache()
    return out


def _ffn_bwd_dx_sweep(g):
    """dx against its plain version over d_model 128-1024 (d_ff 4H), token
    counts around the 128-token tile up to 16,384, every activation, with
    and without dropout (relu under relu_slack); run twice for the same
    bits."""
    seen = []
    for hid in (128, 256, 512, 768, 1024):
        ff = 4 * hid
        w1, b1 = _rand(g, hid, ff, scale=hid ** -0.5), _rand(g, ff, scale=0.1)
        w2, b2 = _rand(g, ff, hid, scale=ff ** -0.5), _rand(g, hid, scale=0.1)
        for t in (1, 31, 100, 1000, 32 * SEQ):
            x, gr = _rand(g, t, hid), _rand(g, t, hid)
            worst = 0.0
            for act in ("gelu", "gelu_tanh", "relu"):
                for p in (0.0, 0.1):
                    got = []
                    for _ in range(2):
                        grads, _, launch = F._ffn_bwd_launchers(
                            x, w1, b1, w2, b2, 17, gr, act, p)
                        launch()
                        got.append(grads[0])
                    want = F.ffn_backward_reference(x, w1, b1, w2, b2, 17, gr,
                                                    act, p)[0]
                    slack = (relu_slack(x, w1, b1, w2, gr, 17, p)["dx"]
                             if act == "relu" else 0.0)
                    ok, err = close_grad(got[0], want, slack)
                    worst = max(worst, err)
                    if not ok or not torch.equal(got[0], got[1]):
                        raise AssertionError(
                            f"ffn_bwd_dx at H={hid} T={t} {act} p={p}: err "
                            f"{err}, same bits twice "
                            f"{torch.equal(got[0], got[1])}")
            seen.append(dict(h=hid, t=t, max_abs_err=worst))
            del x, gr
        del w1, b1, w2, b2
        log(f"ffn_bwd_dx sweep H={hid}: T in (1, 31, 100, 1000, 16384) x "
            f"gelu/gelu_tanh/relu x dropout 0/0.1 agree, same bits twice; "
            f"worst err {max(r['max_abs_err'] for r in seen[-5:]):.3g}")
    torch.cuda.empty_cache()
    return seen


def _ffn_act_case(g, t, f, act, p, dtype):
    """The element pass forward and backward at one shape against their
    plain versions: values within ACT_TOL, every value the hash drops
    exactly 0 in h and dpre, the same bits on a second launch.  Returns
    the two max abs errors."""
    pre = (torch.randn(t, f, generator=g) * 2.0).to("cuda", dtype)
    b1 = (torch.randn(f, generator=g) * 0.1).to("cuda", dtype)
    dh = torch.randn(t, f, generator=g).to("cuda", dtype)
    h = F.ffn_act_fwd(pre, b1, act, p, 99)
    dpre, h2 = F.ffn_act_bwd(pre, b1, dh, act, p, 99)
    again = F.ffn_act_fwd(pre, b1, act, p, 99)
    torch.cuda.synchronize()
    want_h = F.ffn_act_fwd_reference(pre, b1, act, p, 99)
    want_dpre, _ = F.ffn_act_bwd_reference(pre, b1, dh, act, p, 99)
    ok_h, err_h = close(h, want_h, **ACT_TOL[dtype])
    ok_d, err_d = close(dpre, want_dpre, **ACT_TOL[dtype])
    mask_ok = True
    if p > 0.0:
        drop = ~F._ffn_keep(99, 0, 0, t, f, p, device=pre.device)
        mask_ok = not bool(h[drop].any()) and not bool(dpre[drop].any())
    same = torch.equal(h, again) and torch.equal(h, h2)
    ok = ok_h and ok_d and mask_ok and same
    log(f"ffn_act T={t} F={f} {act} p={p} {str(dtype)[6:]}: h err "
        f"{err_h:.3g}, dpre err {err_d:.3g}, dropped values 0 {mask_ok}, "
        f"same bits (twice, and the backward's h) {same} "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"ffn_act disagrees with its plain version at "
                             f"T={t} F={f} {act} p={p} {dtype}")
    return err_h, err_d


def _ffn_act_rows(g):
    """The element pass of the FFN's library arm (csrc/ffn_act.cu): each
    kernel against its plain version (the vector path, and F not a whole
    number of 16-byte vectors for the per-value path; every activation;
    bf16 and f32), the dropout mask bit for bit (relu over positive
    pre: h is non-zero exactly where `_ffn_keep` keeps), then graph-timed
    at the train step's shape (T=16384, F=3072, gelu, dropout 0.1) beside
    its bound (bytes over 3.35 TB/s) and the eager ATen bias + gelu (no
    dropout: no single PyTorch call computes the function, so
    library_ms is null)."""
    worst = {"ffn_act_fwd": 0.0, "ffn_act_bwd": 0.0}
    bf16 = torch.bfloat16
    for t, f, act, p, dtype in [
            (32 * SEQ, 3072, "gelu", 0.1, bf16),
            (32 * SEQ, 3072, "gelu", 0.0, bf16),
            (1000, 3072, "relu", 0.1, bf16),
            (17, 3072, "gelu_tanh", 0.1, bf16),
            (33, 100, "gelu", 0.1, bf16), (5, 36, "relu", 0.0, bf16),
            (64, 128, "gelu", 0.1, torch.float32),
            (37, 130, "gelu_tanh", 0.0, torch.float32)]:
        err_h, err_d = _ffn_act_case(g, t, f, act, p, dtype)
        if dtype == bf16:
            worst["ffn_act_fwd"] = max(worst["ffn_act_fwd"], err_h)
            worst["ffn_act_bwd"] = max(worst["ffn_act_bwd"], err_d)
    # the mask bit for bit
    t, f, p = 1000, 3072, 0.1
    pre = torch.full((t, f), 3.0, dtype=bf16, device="cuda")
    zero = torch.zeros(f, dtype=bf16, device="cuda")
    keep = F._ffn_keep(77, 0, 0, t, f, p, device=pre.device)
    h = F.ffn_act_fwd(pre, zero, "relu", p, 77)
    dpre, _ = F.ffn_act_bwd(pre, zero, torch.ones_like(pre), "relu", p, 77)
    if not (torch.equal(h != 0, keep) and torch.equal(dpre != 0, keep)):
        raise AssertionError("ffn_act's dropout mask is not _ffn_keep's")
    log(f"ffn_act mask: kept {float(keep.float().mean()):.4f} of {t}x{f}, "
        f"bit for bit with _ffn_keep in both passes")
    # timing at the train step's shape
    t, f = 32 * SEQ, 3072
    pre, dh = _rand(g, t, f, scale=2.0), _rand(g, t, f)
    b1 = _rand(g, f, scale=0.1)
    times = K4.graphs_ms({
        "ffn_act_fwd": lambda: [F.ffn_act_fwd(pre, b1, "gelu", 0.1, 5)
                                for _ in range(4)],
        "ffn_act_bwd": lambda: [F.ffn_act_bwd(pre, b1, dh, "gelu", 0.1, 5)
                                for _ in range(4)],
        "aten_bias_gelu": lambda: [torch.nn.functional.gelu(pre + b1)
                                   for _ in range(4)]}, 4)
    plain = {
        "ffn_act_fwd": time_ms(lambda: F.ffn_act_fwd_reference(
            pre, b1, "gelu", 0.1, 5), iters=2, warmup=1),
        "ffn_act_bwd": time_ms(lambda: F.ffn_act_bwd_reference(
            pre, b1, dh, "gelu", 0.1, 5), iters=2, warmup=1)}
    rows = []
    for name, n_tf in (("ffn_act_fwd", 2), ("ffn_act_bwd", 4)):
        nbytes = (n_tf * t * f + f) * 2
        rows.append(dict(
            name=name, route="cuda", source="paddle_tpu_torch/csrc/ffn_act.cu",
            replaces="none: the fusion XLA makes of paddle_tpu/ops/pallas/"
                     "ffn.py:506-516 (fused_ffn's non-kernel arm)",
            max_abs_err=worst[name], ms=times[name], plain_ms=plain[name],
            bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
            library_ms=None, aten_bias_gelu_ms=times["aten_bias_gelu"],
            shape=f"pre{'/dh' if n_tf == 4 else ''} ({t},{f}) bf16, b1 "
                  f"({f}), gelu, dropout 0.1",
            bytes=nbytes, tolerance=ACT_TOL[bf16]))
    return rows


def _flash_case(g, b, sq, sk, masked, p, seed=13, backward=True):
    """flash_fwd (and, with `backward`, dkv and dq) at one shape, no
    causal mask, against the plain versions, each run twice for the same
    bits.  Returns ((q, k, v, bias, out, lse, g), fwd err, dkv err, dq
    err)."""
    h, d = WMT_HEADS, 64
    q, k, v = _rand(g, b, sq, h, d), _rand(g, b, sk, h, d), _rand(
        g, b, sk, h, d)
    gr = _rand(g, b, sq, h, d)
    bias = _padding_bias(g, b, sk) if masked else None
    out, lse = A.flash_forward(q, k, v, bias, seed, False, None, None, p)
    again = A.flash_forward(q, k, v, bias, seed, False, None, None, p)
    torch.cuda.synchronize()
    ref, ref_lse = A.flash_forward_reference(q, k, v, bias, seed, False,
                                             None, None, p)
    ok_o, err = close(out, ref, **BF16_TOL)
    ok_l, err_l = close(lse, ref_lse, **LSE_TOL)
    same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
    errs = {"flash_fwd": err}
    ok = ok_o and ok_l and same
    if backward:
        got = A.flash_backward(q, k, v, bias, seed, out, lse, gr, False,
                               None, None, p)
        got2 = A.flash_backward(q, k, v, bias, seed, out, lse, gr, False,
                                None, None, p)
        torch.cuda.synchronize()
        want = A.flash_backward_reference(q, k, v, bias, seed, out, lse, gr,
                                          False, None, None, p)
        checks = [close_grad(a, w) for a, w in zip(got, want)]
        same = same and all(torch.equal(a, c) for a, c in zip(got, got2))
        ok = ok and same and all(c[0] for c in checks)
        errs["flash_bwd_dq"] = checks[0][1]
        errs["flash_bwd_dkv"] = max(checks[1][1], checks[2][1])
    log(f"flash B={b} Sq={sq} Sk={sk} H={h} masked={masked} p={p}: "
        + " ".join(f"{n} err {e:.3g}" for n, e in errs.items())
        + f", LSE err {err_l:.3g}, same bits twice {same} "
        + ("ok" if ok else "MISMATCH"))
    if not ok:
        raise AssertionError(f"flash kernels disagree with their plain "
                             f"versions at B={b} Sq={sq} Sk={sk} "
                             f"masked={masked} p={p}")
    return (q, k, v, bias, out, lse, gr), errs


def _wmt_kernel_holds(g, rows):
    """The kernels at the WMT Transformer's shapes (phase 14), each
    against its plain version and run twice for the same bits, then
    graph-timed in turns with the PyTorch call beside its bound; the
    results go into the rows' `wmt` entries and their max_abs_err.
    - the train step's cross-attention, T=120 queries against S=128 keys
      (Sq != Sk), B=32, 8 heads of 64, with and without a key-padding
      bias, at dropout 0.1 (the step's) and 0: flash_fwd, dkv and dq;
    - the decode steps: one query a row, B*W=32 rows (B*H = 256),
      against t = 1, 7, 32 keys of the self-attention cache and the 128
      of the cross-attention's: flash_fwd;
    - the FFN's element pass at relu, T=3840 (32 x 120), F=2048, bf16,
      dropout 0.1 and 0: bit for bit (relu has no approximation)."""
    b, t_len, s_len, h, d = WMT_BATCH, WMT_TGT, WMT_SRC, WMT_HEADS, 64
    worst = {}
    for masked in (False, True):
        for p in (0.1, 0.0):
            (q, k, v, bias, out, lse, gr), errs = _flash_case(
                g, b, t_len, s_len, masked, p)
            for n, e in errs.items():
                worst[n] = max(worst.get(n, 0.0), e)
    # timing at the path's configuration: no mask (the step has none),
    # the forward and both backward kernels at dropout 0.1 and 0, SDPA
    # (no dropout) and its backward as (forward + backward) - forward
    (q, k, v, _, out, lse, gr), _ = _flash_case(g, b, t_len, s_len, False,
                                                0.1, backward=False)
    scale = d ** -0.5
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    gt = gr.transpose(1, 2)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt)
    arms = {"flash_fwd p=0.1": lambda: A.flash_forward(
                q, k, v, None, 13, False, None, None, 0.1),
            "flash_fwd p=0.0": lambda: A.flash_forward(q, k, v),
            "sdpa forward": sdpa,
            "sdpa forward+backward": lambda: torch.autograd.grad(
                sdpa(), (qt, kt, vt), gt)}
    for p in (0.1, 0.0):
        _, dkv, dq = A._flash_bwd_launchers(q, k, v, None, 13, out, lse,
                                            gr, False, 0, scale, p)
        arms[f"flash_bwd_dkv p={p}"], arms[f"flash_bwd_dq p={p}"] = dkv, dq
    times = K4.graphs_ms({key: (lambda fn=fn: [fn() for _ in range(4)])
                          for key, fn in arms.items()}, 4)
    sdpa_bwd = times["sdpa forward+backward"] - times["sdpa forward"]
    log("WMT cross-attention (32,120|128,8,64) graph-timed, ms a call: "
        + ", ".join(f"{key} {ms:.4f}" for key, ms in times.items())
        + f"; SDPA backward {sdpa_bwd:.4f}")
    # bytes of one query-side tensor (q, g, out, dq), one key-side tensor
    # (k, v, dk, dv), one f32 row vector (lse, delta)
    qb, kb = b * t_len * h * d * 2, b * s_len * h * d * 2
    rb = b * h * t_len * 4
    product = 2 * b * h * t_len * s_len * d
    shape = f"q/g ({b},{t_len},{h},{d}), k/v ({b},{s_len},{h},{d}) bf16"
    for name, n_products, nbytes, lib in (
            ("flash_fwd", 2, 2 * qb + 2 * kb + rb, times["sdpa forward"]),
            ("flash_bwd_dkv", 4, 2 * qb + 4 * kb + 2 * rb, sdpa_bwd),
            ("flash_bwd_dq", 3, 3 * qb + 2 * kb + 2 * rb, sdpa_bwd)):
        bound_ms, bound_by = bound(n_products * product, nbytes)
        rows[name]["wmt"] = dict(
            shape=shape + ", dropout 0.1, no mask", ms=times[f"{name} p=0.1"],
            ms_dropout0=times[f"{name} p=0.0"], library_ms=lib,
            bound_ms=bound_ms, bound_by=bound_by, max_abs_err=worst[name])
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        worst[name])
        log(f"{name} at the WMT cross-attention: {times[f'{name} p=0.1']:.4f}"
            f" ms (dropout 0: {times[f'{name} p=0.0']:.4f}), library "
            f"{lib:.4f}, bound {bound_ms:.4f} {bound_by}")
    del q, k, v, qt, kt, vt, gt, gr, out, lse
    # the decode steps: Sq = 1
    decode = []
    for keys in (1, 7, 32, s_len):
        (q, k, v, *_), errs = _flash_case(g, b, 1, keys, False, 0.0,
                                          backward=False)
        worst["flash_fwd"] = max(worst["flash_fwd"], errs["flash_fwd"])
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        times = K4.graphs_ms({
            "kernel": lambda: [A.flash_forward(q, k, v) for _ in range(12)],
            "sdpa": lambda: [torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt) for _ in range(12)]}, 12)
        bound_ms, bound_by = bound(4 * b * h * keys * d,
                                   (2 * b + 2 * b * keys) * h * d * 2
                                   + b * h * 4)
        decode.append(dict(keys=keys, ms=times["kernel"],
                           library_ms=times["sdpa"], bound_ms=bound_ms,
                           bound_by=bound_by, max_abs_err=errs["flash_fwd"]))
        log(f"flash_fwd at a WMT decode step (32,1|{keys},8,64): "
            f"{times['kernel']:.4f} ms, SDPA {times['sdpa']:.4f}, bound "
            f"{bound_ms:.4f} {bound_by}")
    rows["flash_fwd"]["wmt"]["decode"] = decode
    rows["flash_fwd"]["max_abs_err"] = max(rows["flash_fwd"]["max_abs_err"],
                                           worst["flash_fwd"])
    # the element pass at relu, bit for bit
    t, f = b * t_len, WMT_FF
    for p in (0.1, 0.0):
        pre, dh = _rand(g, t, f, scale=2.0), _rand(g, t, f)
        b1 = _rand(g, f, scale=0.1)
        h_out = F.ffn_act_fwd(pre, b1, "relu", p, 21)
        dpre, h2 = F.ffn_act_bwd(pre, b1, dh, "relu", p, 21)
        again = F.ffn_act_fwd(pre, b1, "relu", p, 21)
        dpre2, _ = F.ffn_act_bwd(pre, b1, dh, "relu", p, 21)
        torch.cuda.synchronize()
        want_h = F.ffn_act_fwd_reference(pre, b1, "relu", p, 21)
        want_d, _ = F.ffn_act_bwd_reference(pre, b1, dh, "relu", p, 21)
        ok = (torch.equal(h_out, want_h) and torch.equal(h2, want_h)
              and torch.equal(dpre, want_d) and torch.equal(again, h_out)
              and torch.equal(dpre2, dpre))
        log(f"ffn_act relu T={t} F={f} p={p}: h and dpre bit for bit with "
            f"the plain versions, and twice: {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"ffn_act relu is not bit for bit at T={t} "
                                 f"F={f} p={p}")
    times = K4.graphs_ms({
        "ffn_act_fwd": lambda: [F.ffn_act_fwd(pre, b1, "relu", 0.1, 5)
                                for _ in range(4)],
        "ffn_act_bwd": lambda: [F.ffn_act_bwd(pre, b1, dh, "relu", 0.1, 5)
                                for _ in range(4)],
        "aten_bias_relu": lambda: [torch.relu(pre + b1) for _ in range(4)]},
        4)
    for name, n_tf in (("ffn_act_fwd", 2), ("ffn_act_bwd", 4)):
        nbytes = (n_tf * t * f + f) * 2
        rows[name]["wmt"] = dict(
            shape=f"pre{'/dh' if n_tf == 4 else ''} ({t},{f}) bf16, relu, "
                  f"dropout 0.1", ms=times[name], max_abs_err=0.0,
            bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
            aten_bias_relu_ms=times["aten_bias_relu"], bit_for_bit=True)
        log(f"{name} relu at the WMT FFN ({t},{f}): {times[name]:.4f} ms, "
            f"bound {nbytes / PEAK_BYTES * 1e3:.4f} bytes; ATen bias + relu "
            f"(no dropout) {times['aten_bias_relu']:.4f}")


@phase("probe")
def probe():
    """The layout probe's main path, then each probe kernel against its
    plain version and timed alone; returns (rows, launches)."""
    for c in COUNTERS.values():
        c.reset()
    # -- the main path: counters at 0 before, read right after --------------
    result = K4.run()
    launches = {n: c.value for n, c in COUNTERS.items()}
    # ------------------------------------------------------------------------
    log("kernel4d_probe (python -m paddle_tpu_torch.tools.kernel4d_probe):")
    log(json.dumps(result))
    if not result["ok"]:
        raise AssertionError(f"the probe failed: builds {result['builds']}, "
                             f"max_err {result['max_err']}")
    want = {n: 0 for n in COUNTERS}
    want.update({n: 1 + 2 * K4.UNROLL for n in PROBE_KERNELS},
                flash_fwd=2 * K4.UNROLL)
    log(f"kernel launches on the main path: {launches}")
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")

    g = torch.Generator().manual_seed(1)
    worst = {n: 0.0 for n in PROBE_KERNELS}
    for b, s, h, d in [(8, SEQ, 12, 64), (2, 200, 12, 64), (4, SEQ, 6, 128),
                       (2, 4 * SEQ, 4, 64)]:
        q, k, v = (_rand(g, b, s, h, d) for _ in range(3))
        q3, k3, v3 = (x.view(b, s, h * d) for x in (q, k, v))
        qm, km, vm = (P.merge_heads(x) for x in (q, k, v))
        launch = {"probe_4d": lambda: P.probe_4d(q, k, v),
                  "probe_fold3d": lambda: P.probe_fold3d(q3, k3, v3, h),
                  "probe_merged": lambda: P.probe_merged(qm, km, vm)}
        got = {n: fn() for n, fn in launch.items()}
        torch.cuda.synchronize()
        want_o = {"probe_4d": P.probe_4d_reference(q, k, v),
                  "probe_fold3d": P.probe_fold3d_reference(q3, k3, v3, h),
                  "probe_merged": P.probe_merged_reference(qm, km, vm)}
        checks = {n: close(got[n], want_o[n], **BF16_TOL) for n in got}
        # one kernel body behind three maps: the same bits in every layout
        alike = (torch.equal(got["probe_4d"],
                             got["probe_fold3d"].view(b, s, h, d))
                 and torch.equal(got["probe_4d"],
                                 P.unmerge_heads(got["probe_merged"], h)))
        # and on a second launch, at the tool's shape
        at_tool = (b, s, h, d) == (8, SEQ, 12, 64)
        twice = not at_tool or all(
            torch.equal(fn(), got[n]) for n, fn in launch.items())
        for n, (_, err) in checks.items():
            worst[n] = max(worst[n], err)
        log(f"probe B={b} S={s} H={h} D={d}: "
            + " ".join(f"{n} err {c[1]:.3g}" for n, c in checks.items())
            + f"; 4d, fold3d and merged bit for bit alike: {alike}"
            + (f"; the same bits on a second launch: {twice}"
               if at_tool else ""))
        if not (all(c[0] for c in checks.values()) and alike and twice):
            raise AssertionError(f"a probe kernel disagrees at B={b} S={s} "
                                 f"H={h} D={d}")

    # each kernel alone at the tool's shape, cycling 4 input sets (100 MB,
    # past the 50 MB L2), by CUDA graph replay in turns with SDPA on the
    # same operands
    b, s, h, d = 8, SEQ, 12, 64
    sets = [tuple(_rand(g, b, s, h, d, scale=0.3) for _ in range(3))
            for _ in range(4)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    to3 = lambda a: tuple(x.view(b, s, h * d) for x in a)
    merged = [tuple(P.merge_heads(x) for x in a) for a in sets]
    cycle = lambda fn, args: lambda: [fn(a) for a in args]
    graphs = {
        "probe_4d": cycle(lambda a: P.probe_4d(*a), sets),
        "probe_fold3d": cycle(lambda a: P.probe_fold3d(*a, h),
                              [to3(a) for a in sets]),
        "probe_merged": cycle(lambda a: P.probe_merged(*a), merged),
        "sdpa": cycle(lambda a: sdpa(*(x.transpose(1, 2) for x in a)),
                      sets),
        # (B*H, 1, S, D): SDPA's fused kernels take 4-D operands only
        "sdpa_merged": cycle(lambda a: sdpa(*(x[:, None] for x in a)),
                             merged)}
    ms = K4.graphs_ms(graphs, len(sets))
    plain = {"probe_4d": lambda: P.probe_4d_reference(*sets[0]),
             "probe_fold3d": lambda: P.probe_fold3d_reference(
                 *to3(sets[0]), h),
             "probe_merged": lambda: P.probe_merged_reference(*merged[0])}
    flops = 4 * b * h * s * s * d
    nbytes = 4 * b * s * h * d * 2
    bound_ms, bound_by = bound(flops, nbytes)
    rows = []
    for name, line, arm, shape in (
            ("probe_4d", "29", "4d", f"q/k/v ({b},{s},{h},{d}) bf16"),
            ("probe_fold3d", "78", "fold3d", f"q/k/v ({b},{s},{h * d}) bf16"),
            ("probe_merged", "140", "merged",
             f"q/k/v ({b * h},{s},{d}) bf16")):
        rows.append(dict(
            name=name, route="cuda", source="paddle_tpu_torch/csrc/probe4d.cu",
            replaces=f"tools/kernel4d_probe.py:{line}",
            max_abs_err=worst[name], ms=ms[name],
            plain_ms=time_ms(plain[name], iters=3, warmup=1),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=ms["sdpa_merged" if arm == "merged" else "sdpa"],
            chain_ms=result[K4.ARM_CHAINS[arm]],
            shape=shape, flops=flops, bytes=nbytes, tolerance=BF16_TOL))
    for r in rows:
        log(f"{r['name']}: {r['ms']:.4f} ms alone, {r['chain_ms']:.4f} ms a "
            f"call in the tool's chain (plain {r['plain_ms']:.4f}, SDPA "
            f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
            f"{r['bound_by']}) at {r['shape']}")
    return rows, launches


def _request_batches(cfg, n, seed):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        rows = int(rng.integers(1, 17))
        fb = bert.fake_batch(cfg, rows, SEQ, seed=seed * 1000 + i)
        reqs.append([fb["input_ids"], fb["token_type_ids"],
                     fb["attention_mask"]])
    return reqs


@phase("slice")
def serve_slice(kernel_ms):
    cfg = bert.BertConfig.base()
    t0 = time.perf_counter()
    model = bert.BertModel(cfg, dtype=torch.bfloat16, seed=0).eval()
    log(f"BertModel(base) on {next(model.parameters()).device}: "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, "
        f"built in {time.perf_counter() - t0:.1f} s")
    calls = [0]
    calls_lock = threading.Lock()  # the warm-up and dispatch threads

    def fn(input_ids, token_type_ids, attention_mask):
        with calls_lock:
            calls[0] += 1
        am = (attention_mask != 0)[:, None, None, :]
        return model(input_ids, token_type_ids, attention_mask=am)

    reqs = _request_batches(cfg, 40, seed=7)
    resps = [None] * len(reqs)
    n_clients = 4

    def client(lo):
        for i in range(lo, len(reqs), n_clients):
            resps[i] = engine.submit(reqs[i])
            time.sleep(0.002)

    profiler.stat_reset()
    profiler.time_reset()
    reset_latency()
    for c in COUNTERS.values():
        c.reset()
    # -- the main path: counters at 0 before, read right after --------------
    t0 = time.perf_counter()
    engine = Engine(fn, EngineConfig(max_batch_size=32,
                                     max_queue_delay_ms=5.0, max_queue=64,
                                     max_in_flight=2))
    threads = [threading.Thread(target=client, args=(lo,))
               for lo in range(n_clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    results = [r.result(timeout=300) for r in resps]
    engine.shutdown(drain=True)
    wall = time.perf_counter() - t0
    launches = {n: c.value for n, c in COUNTERS.items()}
    # ------------------------------------------------------------------------
    stats = profiler.get_int_stats()
    times = profiler.get_time_stats()
    lat = latency_stats()
    rows_total = sum(r[0].shape[0] for r in reqs)
    log(f"served {len(reqs)} requests, {rows_total} rows x {SEQ} tokens in "
        f"{wall:.2f} s ({rows_total * SEQ / wall:.0f} tokens/s, host clock)")
    log(f"request latency ms: p50 {lat['p50_ms']:.1f} p99 {lat['p99_ms']:.1f}"
        f" max {lat['max_ms']:.1f}")
    log(f"batches {stats['serving_batches_total']}, mean occupancy "
        f"{mean_occupancy(stats):.2f} requests / "
        f"{stats['serving_batch_rows_total'] / stats['serving_batches_total']:.1f}"
        f" rows per batch, pad rows {stats.get('serving_pad_rows_total', 0)}, "
        f"warm-ups {stats.get('serving_trace_count', 0)}, model calls {calls[0]}")
    log("serving_* int stats: " + json.dumps(
        {k: v for k, v in sorted(stats.items()) if k.startswith("serving")}))
    log("serving_* times ms: " + json.dumps(
        {k: round(v, 3) for k, v in sorted(times.items())}))
    log(f"kernel launches on the main path: {launches}")
    expect_calls = stats["serving_batches_total"] + stats.get(
        "serving_trace_count", 0)
    if calls[0] != expect_calls:
        raise AssertionError(f"model calls {calls[0]} != batches + warm-ups "
                             f"{expect_calls}")
    for name, n in launches.items():
        want = cfg.num_hidden_layers * calls[0] \
            if name in FORWARD_KERNELS else 0  # serving runs no backward
        if n != want or (name in FORWARD_KERNELS and n == 0):
            raise AssertionError(
                f"{name}: {n} launches for {calls[0]} model calls (want "
                f"{want})")

    # every response finite, and equal to a direct forward of its rows
    worst_max, worst_mean = 0.0, 0.0
    with torch.inference_mode():
        for req, (enc, pooled) in zip(reqs, results):
            r = req[0].shape[0]
            if enc.shape != (r, SEQ, cfg.hidden_size) or \
                    pooled.shape != (r, cfg.hidden_size):
                raise AssertionError(f"bad response shapes {enc.shape} "
                                     f"{pooled.shape}")
            if not (np.isfinite(enc).all() and np.isfinite(pooled).all()):
                raise AssertionError("non-finite response")
            d_enc, d_pooled = fn(*[torch.from_numpy(a).cuda() for a in req])
            for got, want in ((enc, d_enc), (pooled, d_pooled)):
                err = np.abs(got - want.float().cpu().numpy())
                worst_max = max(worst_max, float(err.max()))
                worst_mean = max(worst_mean, float(err.mean()))
    log(f"responses vs direct forward: max abs {worst_max:.4g} (limit "
        f"{SERVE_MAX_ABS}), worst mean abs {worst_mean:.4g} (limit "
        f"{SERVE_MEAN_ABS})")
    if worst_max > SERVE_MAX_ABS or worst_mean > SERVE_MEAN_ABS:
        raise AssertionError("served responses disagree with the direct "
                             "forward")

    # where the time of one top-bucket batch goes: the direct forward of
    # 32 rows against the two kernels' times at that shape (phase 3)
    batch = [torch.from_numpy(np.concatenate(cols)[:32]).cuda()
             for cols in zip(*reqs)]
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: fn(*batch), iters=5, warmup=1)
    log(f"forward B=32 S={SEQ}: {fwd_ms:.3f} ms")
    for name in FORWARD_KERNELS:
        ms = (kernel_ms or {}).get(name, float("nan"))
        share = cfg.num_hidden_layers * ms / fwd_ms
        log(f"  {name}: {cfg.num_hidden_layers} x {ms:.4f} ms = "
            f"{100 * share:.1f}% of the forward")
    return launches


def bert_decoder(model) -> LayeredDecoder:
    """BertForPretraining as a causal LayeredDecoder: the embeddings at
    the given positions, each encoder layer as (q/k/v split into heads,
    post-LN attention-output and FFN halves), the tied MLM head as the
    unembedding.  The engine's masking makes it causal."""
    bert_, cls = model.bert, model.cls
    top = bert_.config.max_position_embeddings - 1

    def embed(tokens, positions):
        # padded rows of a bucket may run past the position table
        return bert_.embeddings(tokens,
                                position_ids=positions.clamp(max=top))

    def make_layer(layer):
        sa = layer.self_attn

        def qkv(x, positions):
            return tuple(sa._split_heads(p(x))
                         for p in (sa.q_proj, sa.k_proj, sa.v_proj))

        def merge(x, attn):
            b, t = attn.shape[0], attn.shape[1]
            h = layer.norm1(x + sa.out_proj(attn.reshape(b, t, -1)))
            return layer.norm2(h + _dense_ffn_block(layer, h))

        return qkv, merge

    def unembed(x):
        y = cls.layer_norm(cls.activation(cls.transform(x)))
        return torch.matmul(y, cls.decoder_weight.t()) + cls.decoder_bias

    return LayeredDecoder(embed, [make_layer(lyr) for lyr in
                                  bert_.encoder.layers], unembed)


def _decode_traffic(vocab):
    """Part A: 16 prompts of 64-256 tokens, 96 new tokens each.  Part B:
    16 prompts of 16-448 tokens (the first 448, three more over 256, so
    four take the chunk path), 16-64 new tokens each."""
    rng = np.random.default_rng(5)
    toks = lambda n: rng.integers(0, vocab, n).astype(np.int32)
    part_a = [(toks(int(n)), 96) for n in rng.integers(64, 257, SLOTS)]
    lens_b = [448] + [int(n) for n in rng.integers(257, 449, 3)] + \
        [int(n) for n in rng.integers(16, 257, SLOTS - 4)]
    part_b = [(toks(n), int(m)) for n, m in
              zip(lens_b, rng.integers(16, 65, SLOTS))]
    return part_a, part_b


def _teacher_forced(dec, prompt, tokens):
    """Logits of a dense causal forward of prompt + tokens[:-1] through
    the same decoder on the card (attention: the plain dense version),
    at the positions that produced each generated token."""
    seq = np.concatenate([prompt, np.asarray(tokens[:-1], np.int32)])
    n = len(seq)
    pos = torch.arange(n, dtype=torch.int32, device="cuda")[None]
    x = dec.embed(torch.from_numpy(seq).cuda()[None], pos)
    for qkv, merge in dec.layers:
        q, k, v = qkv(x, pos)
        x = merge(x, A.dense_attention(q, k, v, is_causal=True))
    return dec.unembed(x)[0, len(prompt) - 1:].float()


@phase("decode")
def decode(kernel_rows):
    cfg = bert.BertConfig.base()
    t0 = time.perf_counter()
    model = bert.BertForPretraining(cfg, dtype=torch.bfloat16, seed=0).eval()
    dec = bert_decoder(model)
    part_a, part_b = _decode_traffic(cfg.vocab_size)
    log(f"BertForPretraining(base) bf16 as a causal decoder, built in "
        f"{time.perf_counter() - t0:.1f} s; prompts A "
        f"{sorted(len(p) for p, _ in part_a)}, B "
        f"{[len(p) for p, _ in part_b]}, new tokens B "
        f"{[m for _, m in part_b]}")
    profiler.stat_reset()
    profiler.time_reset()
    reset_latency()
    torch.cuda.synchronize()
    for c in COUNTERS.values():
        c.reset()
    # -- the main path: counters at 0 before, read right after --------------
    eng = AutoregressiveEngine(
        model=dec, num_heads=cfg.num_attention_heads,
        head_dim=cfg.hidden_size // cfg.num_attention_heads,
        num_pages=NUM_PAGES, page_size=PAGE_SIZE, max_slots=SLOTS,
        max_pages_per_seq=ROW_PAGES, max_queue=64,
        prompt_buckets=PROMPT_BUCKETS, prefill_chunk=PREFILL_CHUNK,
        dtype=torch.bfloat16)
    log(f"KV pool {tuple(eng.kv.k.shape)} x2 bf16: "
        f"{2 * eng.kv.k.numel() * 2 / 1e6:.1f} MB")
    t_fill = time.perf_counter()
    reqs = [eng.submit(p, m) for p, m in part_a]
    warm_steps = 0
    while eng._pending or eng._prefilling:
        eng.step()
        warm_steps += 1
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t_fill
    # part A, steady state: 16 slots decoding, no admission or retirement
    torch.cuda.synchronize()
    decoding0 = profiler.get_int_stats().get("serving_decode_steps", 0)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    h0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        e0.record()
        for _ in range(TIMED_STEPS):
            eng.step()
        e1.record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - h0) * 1e3 / TIMED_STEPS
    step_ms = e0.elapsed_time(e1) / TIMED_STEPS
    stats = profiler.get_int_stats()
    if stats["serving_decode_steps"] - decoding0 != TIMED_STEPS \
            or stats.get("serving_completed_total", 0) or eng._pending:
        raise AssertionError("the timed window was not 32 decode steps of "
                             "16 slots")
    busy, wall_ms, top = _profile_steps(eng)
    # part B: mixed traffic, submitted while part A decodes
    reset_latency("serving_ttft_ms")
    reset_latency("serving_prefill_chunk_ms")
    steps_b = profiler.get_int_stats()["serving_decode_steps"]
    tokens_a = sum(eng._slot_gen)  # generated so far (the host mirror)
    t_b = time.perf_counter()
    reqs += [eng.submit(p, m) for p, m in part_b]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t_b
    launches = {n: c.value for n, c in COUNTERS.items()}
    # ------------------------------------------------------------------------
    stats = profiler.get_int_stats()
    times = profiler.get_time_stats()
    prompts = [p for p, _ in part_a + part_b]
    results = [r.result(timeout=0) for r in reqs]
    steps_b = stats["serving_decode_steps"] - steps_b
    tokens_b = sum(len(r) for r in results) - tokens_a
    log(f"decode: {len(reqs)} requests, {sum(len(r) for r in results)} "
        f"tokens; part A filled {SLOTS} slots in {warm_steps} steps "
        f"({fill_s:.2f} s host clock, first calls included); part B, from "
        f"its submission until idle: {steps_b} decode steps and "
        f"{tokens_b} tokens in {wall_b:.2f} s host clock "
        f"({tokens_b / wall_b:.0f} tokens/s)")
    log(f"steady state, 16 slots: decode step {step_ms:.3f} ms (CUDA "
        f"events; host clock {host_ms:.3f} ms), "
        f"{SLOTS / (step_ms / 1e3):.0f} tokens/s; no host sync in "
        f"{TIMED_STEPS} steps (sync debug mode 'error')")
    shares = {}
    for name, key in (("ragged_paged", "ms"), ("ffn_fwd", "decode_t16_ms")):
        ms = (kernel_rows or {}).get(name, {}).get(key, float("nan"))
        shares[name] = LAYERS * ms / step_ms
        log(f"  {name}: {LAYERS} x {ms:.4f} ms = {100 * shares[name]:.1f}% "
            f"of the step")
    log(f"profiled {PROFILED_STEPS} decode steps: {wall_ms:.3f} ms host "
        f"clock, device busy {busy:.3f} ms (idle "
        f"{100 * max(0.0, 1 - busy / wall_ms):.1f}%)")
    for key, ms, count in top:
        log(f"  {ms:9.3f} ms {100 * ms / busy:5.1f}% x{count:<5d} {key[:90]}")
    ttft = latency_stats("serving_ttft_ms")
    chunk = latency_stats("serving_prefill_chunk_ms")
    log(f"part B: TTFT p50 {ttft['p50_ms']:.2f} ms p99 {ttft['p99_ms']:.2f}"
        f" ms; serving_prefill_chunk_ms (host clock) p50 "
        f"{chunk['p50_ms']:.3f} p99 {chunk['p99_ms']:.3f} max "
        f"{chunk['max_ms']:.3f}")
    log("serving_* int stats: " + json.dumps(
        {k: v for k, v in sorted(stats.items())
         if k.startswith(("serving", "executor"))}))
    log("serving_* times ms: " + json.dumps(
        {k: round(v, 3) for k, v in sorted(times.items())}))
    log(f"kernel launches on the main path: {launches}")

    # checks, each failing the phase
    for (p, m), toks in zip(part_a + part_b, results):
        if len(toks) != m or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"a request of {m} new tokens returned "
                                 f"{len(toks)} (or ids out of range)")
    if eng.kv.table.in_use != 0:
        raise AssertionError(f"{eng.kv.table.in_use} pages still in use")
    if stats.get("executor_sync_count", 0) != len(reqs):
        raise AssertionError(f"executor_sync_count "
                             f"{stats.get('executor_sync_count')} != "
                             f"{len(reqs)} retirements")
    steps_d = stats["serving_decode_steps"]
    chunks = stats.get("serving_prefill_chunks", 0)
    single = stats["serving_prefill_count"] - sum(
        len(p) > PREFILL_CHUNK for p in prompts)
    want = {n: 0 for n in COUNTERS}
    want.update(ragged_paged=LAYERS * (steps_d + chunks),
                flash_fwd=LAYERS * single,
                ffn_fwd=LAYERS * (single + chunks + steps_d))
    log(f"decode steps {steps_d}, chunk steps {chunks}, single-shot "
        f"prefills {single}: launches wanted {want}")
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    if stats.get("serving_ragged_fallback_total", 0):
        raise AssertionError("the decode path sent paged attention to the "
                             "dense arm")
    worst, agree, total = 0.0, 0, 0
    with torch.inference_mode():
        for prompt, toks in zip(prompts, results):
            logits = _teacher_forced(dec, prompt, toks)
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError("non-finite teacher-forced logits")
            idx = torch.from_numpy(toks.astype(np.int64)).cuda()
            got = logits.gather(1, idx[:, None])[:, 0]
            best = logits.max(dim=1)
            worst = max(worst, float((best.values - got).max()))
            agree += int((best.indices == idx).sum())
            total += len(toks)
    log(f"teacher forcing: worst logit deficit {worst:.4f} (limit "
        f"{DECODE_LOGIT_TOL}), exact argmax agreement {agree}/{total} "
        f"({100 * agree / total:.1f}%)")
    if worst > DECODE_LOGIT_TOL:
        raise AssertionError("a decoded token's logit is too far below the "
                             "teacher-forced maximum")
    summary = dict(step_ms=step_ms, host_step_ms=host_ms,
                   tokens_per_s=SLOTS / (step_ms / 1e3),
                   ragged_share=shares["ragged_paged"],
                   ffn_share=shares["ffn_fwd"],
                   profiled_idle=max(0.0, 1 - busy / wall_ms),
                   ttft_p50_ms=ttft["p50_ms"], ttft_p99_ms=ttft["p99_ms"],
                   part_b_s=wall_b, part_b_tokens=tokens_b,
                   argmax_agreement=agree / total, worst_deficit=worst)
    log("decode summary: " + json.dumps(summary))
    return launches


def _profile_steps(eng):
    """PROFILED_STEPS more decode steps of part A under torch.profiler:
    device busy ms, host wall ms, and the top kernels by device time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda r: -r[1])
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda r: -r[1])
    log(f"  {sum(r[2] for r in kernels) / PROFILED_STEPS:.0f} kernels a "
        f"step; host self time by op (profiler on), top 8:")
    for key, ms, count in host[:8]:
        log(f"    {ms:9.3f} ms x{count:<5d} {key[:80]}")
    return sum(r[1] for r in kernels), wall_ms, kernels[:12]


def _bert_train(steps=5):
    """BertForPretraining(base) through build_pretrain_step at B=32,
    S=512, 76 masked, dropout 0.1: 1 warm-up and `steps` steps timed by
    CUDA events, with the launch and dispatch counters at 0 just before
    (the main path) and read just after.  Raises unless the losses are
    finite and fall and the Adam moments are finite.  Returns (summary,
    launches, dispatch counts, (step, state, batch))."""
    cfg = bert.BertConfig.base()
    batch_size, n_masked = 32, 76
    t0 = time.perf_counter()
    model = bert.BertForPretraining(cfg, seed=0)  # f32, train() mode
    step, state = bert.build_pretrain_step(model)  # bf16 over f32 masters
    fb = bert.fake_batch(cfg, batch_size, SEQ, num_masked=n_masked, seed=11)
    batch = {k: torch.from_numpy(v).cuda() for k, v in fb.items()}
    arm = F._ffn_arm([torch.bfloat16] * 5, cfg.hidden_size,
                     cfg.intermediate_size)
    log(f"BertForPretraining(base) + state built in "
        f"{time.perf_counter() - t0:.1f} s; dropout "
        f"{cfg.hidden_dropout_prob}/{cfg.attention_probs_dropout_prob}, "
        f"B={batch_size} S={SEQ} masked={n_masked} lr={TRAIN_LR}; FFN arm "
        f"{arm}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in COUNTERS.values():
        c.reset()
    for name in ("ffn_dispatch_kernel", "ffn_dispatch_library"):
        profiler.stat_reset(name)
    # -- the main path: counters at 0 before, read right after --------------
    losses = []
    t0 = time.perf_counter()
    state, loss = step(state, batch, TRAIN_LR)  # warm-up
    losses.append(loss)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    e0.record()
    for _ in range(steps):
        state, loss = step(state, batch, TRAIN_LR)
        losses.append(loss)
    e1.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = {n: c.value for n, c in COUNTERS.items()}
    stats = profiler.get_int_stats()
    # ------------------------------------------------------------------------
    dispatch = {n: stats.get(f"ffn_dispatch_{n}", 0)
                for n in ("kernel", "library")}
    step_ms = e0.elapsed_time(e1) / steps
    losses = [float(x) for x in losses]
    log(f"losses: {' '.join(f'{x:.4f}' for x in losses)}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError("train losses are not finite and falling")
    if not all(bool(torch.isfinite(m).all()) for m in state["m"].values()):
        raise AssertionError("a gradient holds a NaN or inf (moment m)")
    log(f"kernel launches on the main path: {launches}; FFN dispatch "
        f"{dispatch}")
    flops = bert.bert_step_flops(cfg, batch_size, SEQ, n_masked)
    mem = torch.cuda.max_memory_allocated()
    summary = dict(step_ms=step_ms, host_step_ms=host_ms,
                   warmup_step_s=warm_s,
                   tokens_per_s=batch_size * SEQ / (step_ms / 1e3),
                   step_flops=flops,
                   mfu=flops / (step_ms / 1e3) / PEAK_BF16_FLOPS,
                   max_memory_allocated_bytes=mem, losses=losses)
    log(f"train step B={batch_size} S={SEQ}: {step_ms:.3f} ms (CUDA events;"
        f" host clock {host_ms:.3f} ms), {summary['tokens_per_s']:.0f} "
        f"tokens/s, MFU {100 * summary['mfu']:.2f}% of 989 TFLOP/s "
        f"({flops / 1e12:.3f} TFLOP a step), warm-up step {warm_s:.2f} s, "
        f"max_memory_allocated {mem / 2 ** 30:.2f} GiB")
    return summary, launches, dispatch, (step, state, batch)


def _expect_launches(launches, per_step, kernels, what):
    """Each of `kernels` launched per_step times, every other kernel 0."""
    for name, n in launches.items():
        want = per_step if name in kernels else 0
        if n != want:
            raise AssertionError(f"{name}: {n} launches in {what} (want "
                                 f"{want})")


@phase("train")
def train(kernel_ms):
    """The kernel arm (pinned by main): the six kernels, 12 a step."""
    steps = 5
    summary, launches, dispatch, run = _bert_train(steps)
    _expect_launches(launches, LAYERS * (steps + 1), TRAIN_KERNELS,
                     f"{steps + 1} steps")
    if dispatch != {"kernel": LAYERS * (steps + 1), "library": 0}:
        raise AssertionError(f"FFN dispatch {dispatch}")
    total = 0.0
    for name in TRAIN_KERNELS:
        ms = (kernel_ms or {}).get(name, float("nan"))
        share = LAYERS * ms / summary["step_ms"]
        total += share
        log(f"  {name}: {LAYERS} x {ms:.4f} ms = {100 * share:.1f}% of the "
            f"step")
    log(f"  the six kernels: {100 * total:.1f}%; everything else "
        f"{100 * (1 - total):.1f}% by difference")
    log("train summary: " + json.dumps(summary))
    return launches, run, summary


def _profile(fn, top=25):
    """fn() once under torch.profiler: device time by kernel name, the
    device's busy and idle share of the host-clock interval.  Returns
    (busy ms, wall ms, the top kernels)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # kernels only: an operator's row repeats its kernels' device time
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda r: -r[1])
    busy = sum(r[1] for r in kernels)
    log(f"profiled step: {wall_ms:.3f} ms host clock, device busy "
        f"{busy:.3f} ms in {len(kernels)} kernel names (idle "
        f"{100 * max(0.0, 1 - busy / wall_ms):.1f}%)")
    for key, ms, count in kernels[:top]:
        log(f"  {ms:9.3f} ms {100 * ms / busy:5.1f}% x{count:<4d} {key[:90]}")
    return busy, wall_ms, kernels[:top]


@phase("profile")
def profile(run):
    """One more train step under torch.profiler: device time by kernel
    name, the device's busy and idle share of the step."""
    step, state, batch = run
    _profile(lambda: step(state, batch, TRAIN_LR))


def _serving_forward_ms(model, batch):
    with torch.inference_mode():
        return time_ms(lambda: model(*batch[:2], attention_mask=batch[2]),
                       iters=10, warmup=2)


@phase("ffn_arms")
def ffn_arms(kernel_train):
    """The reference's default: fused_ffn on its library arm (cuBLAS
    products around ffn_act_fwd / ffn_act_bwd).  The train step of the
    train phase again: no FFN kernel, 12 launches a step of each element
    pass and each flash kernel, and every FFN call counted as the library
    arm.  Then the serving forward of 32 x 512 under each arm, timed in
    turns, three times, and one library-arm step and forward profiled."""
    steps = 5
    F.disable_fused_ffn("the reference's default: the library arm")
    try:
        summary, launches, dispatch, run = _bert_train(steps)
        _expect_launches(launches, LAYERS * (steps + 1),
                         LIBRARY_TRAIN_KERNELS, f"{steps + 1} library-arm "
                         f"steps")
        if dispatch != {"kernel": 0, "library": LAYERS * (steps + 1)}:
            raise AssertionError(f"FFN dispatch {dispatch}")
        kern = kernel_train or {}
        log(f"train step, library arm {summary['step_ms']:.3f} ms (MFU "
            f"{100 * summary['mfu']:.2f}%, "
            f"{summary['max_memory_allocated_bytes'] / 2 ** 30:.2f} GiB) "
            f"against the kernel arm {kern.get('step_ms', float('nan')):.3f}"
            f" ms (MFU {100 * kern.get('mfu', float('nan')):.2f}%, "
            f"{kern.get('max_memory_allocated_bytes', 0) / 2 ** 30:.2f} GiB)"
            f" on this card")
        step, state, batch = run
        busy, wall, top = _profile(lambda: step(state, batch, TRAIN_LR),
                                   top=15)
        summary.update(profiled_busy_ms=busy, profiled_wall_ms=wall)
        del run, step, state, batch
        torch.cuda.empty_cache()
        cfg = bert.BertConfig.base()
        model = bert.BertModel(cfg, dtype=torch.bfloat16, seed=0).eval()
        fb = bert.fake_batch(cfg, 32, SEQ, seed=5)
        batch = [torch.from_numpy(fb[k]).cuda()
                 for k in ("input_ids", "token_type_ids")]
        batch.append((torch.from_numpy(fb["attention_mask"]).cuda() != 0)
                     [:, None, None, :])
        serve = {"library": [], "kernel": []}
        for arm in ("library", "kernel") * 3:
            if arm == "kernel":
                F.enable_fused_ffn()
            else:
                F.disable_fused_ffn("the reference's default")
            serve[arm].append(_serving_forward_ms(model, batch))
        log(f"serving forward B=32 S={SEQ} in turns (library, kernel) x 3: "
            f"{serve}")
        serve = {k: min(v) for k, v in serve.items()}
        log(f"serving forward B=32 S={SEQ}: library arm "
            f"{serve['library']:.3f} ms, kernel arm {serve['kernel']:.3f} ms"
            f" (the least of three each)")
        F.disable_fused_ffn("the reference's default")
        with torch.inference_mode():
            _profile(lambda: model(*batch[:2], attention_mask=batch[2]),
                     top=8)
        summary["serving_forward_ms"] = serve
        summary["card"] = card_line()
        log("ffn_arms summary: " + json.dumps(summary))
        return launches
    finally:
        F.enable_fused_ffn()


@phase("coverage")
def coverage():
    """BertConfig.tiny() in f32 on the card: neither kernel family takes
    it (f32; d_model 64), so attention goes to dense_attention and the FFN
    to its library arm, whose element pass runs in f32.  Held against the
    same forward on the CPU within COVERAGE_TOL."""
    cfg = bert.BertConfig.tiny()
    gpu = bert.BertModel(cfg, seed=1).eval()
    cpu = bert.BertModel(cfg, device="cpu", seed=1).eval()
    fb = bert.fake_batch(cfg, 2, 64, seed=3)
    am = (torch.from_numpy(fb["attention_mask"]) != 0)[:, None, None, :]
    args = [torch.from_numpy(fb["input_ids"]),
            torch.from_numpy(fb["token_type_ids"]), am]
    for c in COUNTERS.values():
        c.reset()
    for name in ("ffn_dispatch_kernel", "ffn_dispatch_library",
                 "attention_dispatch_dense"):
        profiler.stat_reset(name)
    with torch.inference_mode():
        g_enc, g_pooled = gpu(args[0].cuda(), args[1].cuda(),
                              attention_mask=args[2].cuda())
        torch.cuda.synchronize()
        launches = {n: c.value for n, c in COUNTERS.items()}
        stats = profiler.get_int_stats()
        c_enc, c_pooled = cpu(*args[:2], attention_mask=args[2])
    layers = cfg.num_hidden_layers
    _expect_launches(launches, layers, ("ffn_act_fwd",), "one forward")
    want = {"ffn_dispatch_library": layers, "attention_dispatch_dense":
            layers}
    got = {k: stats.get(k, 0) for k in want}
    if got != want or stats.get("ffn_dispatch_kernel", 0):
        raise AssertionError(f"dispatch counts {stats}, want {want}")
    for name, g, c in (("encoded", g_enc, c_enc),
                       ("pooled", g_pooled, c_pooled)):
        ok, err = close(g.cpu(), c, **COVERAGE_TOL)
        log(f"tiny BERT f32 {name}: card vs CPU max abs {err:.3g} "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok or g.dtype != torch.float32:
            raise AssertionError(f"{name} disagrees with the CPU")
    log(f"tiny BERT f32 on the card: launches {launches}, dispatch {got}")


def _resnet18_step(dev, x, y):
    """resnet18(num_classes=10) from seed 2, one f32 train forward and
    backward on `dev`: logits, loss, gradients and running statistics,
    on the CPU."""
    return _mobile_step(lambda d: VM.resnet18(num_classes=10, device=d,
                                              seed=2), dev, x, y)


def _resnet_check():
    """resnet18(num_classes=10), B=4, 3 x 64 x 64, f32 (TF32 off), one
    train forward and backward on the card against the same on the CPU:
    logits, loss and running statistics within RESNET_TOL, every gradient
    within RESNET_KINK in relative L2.  The same step with TF32 on is
    read against the CPU too, and only logged: what a TF32 leak would
    read."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(4, 3, 64, 64).astype("float32"))
    y = torch.from_numpy(rng.randint(0, 10, 4).astype("int64"))
    gpu, cpu = _resnet18_step("cuda", x, y), _resnet18_step("cpu", x, y)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = _resnet18_step("cuda", x, y)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    tf32_err = dict(
        logits=float((tf32["logits"] - cpu["logits"]).abs().max()),
        stats=max(float((tf32["stats"][k] - b).abs().max())
                  for k, b in cpu["stats"].items()))
    worst = {}
    for name in ("logits", "loss"):
        ok, worst[name] = close(gpu[name], cpu[name], **RESNET_TOL)
        if not ok:
            raise AssertionError(f"resnet18 {name}: card vs CPU "
                                 f"{worst[name]}")
    for k, b in cpu["stats"].items():
        ok, err = close(gpu["stats"][k], b, **RESNET_TOL)
        worst["stats"] = max(worst.get("stats", 0.0), err)
        if not ok:
            raise AssertionError(f"resnet18 running stat {k}: {err}")
    for k, g in cpu["grads"].items():
        rel = float((gpu["grads"][k] - g).norm() / g.norm())
        worst["grads_rel_l2"] = max(worst.get("grads_rel_l2", 0.0), rel)
        if not (rel <= RESNET_KINK and torch.isfinite(gpu["grads"][k]).all()):
            raise AssertionError(f"resnet18 gradient {k}: relative L2 {rel}")
    log(f"resnet18 f32 train step, card vs CPU: max abs logits "
        f"{worst['logits']:.3g}, loss {worst['loss']:.3g}, running stats "
        f"{worst['stats']:.3g} (limit {RESNET_TOL}); gradients' worst "
        f"relative L2 {worst['grads_rel_l2']:.3g} (limit {RESNET_KINK}); "
        f"with TF32 on (read only): max abs logits {tf32_err['logits']:.3g}, "
        f"running stats {tf32_err['stats']:.3g}")
    worst["tf32_read_only"] = tf32_err
    return worst


@phase("resnet")
def resnet():
    """ResNet-50 training at bench_resnet50's chip configuration: B=128,
    3 x 224 x 224, 1000 classes, one batch from RandomState(0) for every
    step, bf16 activations over fp32 masters, lr 0.1, momentum 0.9, BN in
    train mode, channels_last on the card (cuDNN picks its algorithms:
    cudnn.benchmark).  1 warm-up step, RESNET_STEPS steps timed by CUDA
    events, one more under the profiler; then resnet18's f32 card-vs-CPU
    check."""
    torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = True
    t0 = time.perf_counter()
    model = VM.resnet50(num_classes=RESNET_CLASSES)
    step, state = VT.build_train_step(model, lr=RESNET_LR,
                                      momentum=RESNET_MOMENTUM, bf16=True)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(RESNET_BATCH, 3, RESNET_HW, RESNET_HW)
                         .astype("float32")).cuda()
    y = torch.from_numpy(rng.randint(0, RESNET_CLASSES, RESNET_BATCH)
                         .astype("int64")).cuda()
    buffers = [k for k, _ in model.named_buffers()]
    stats0 = {k: state["params"][k].clone() for k in buffers}
    log(f"resnet50: {sum(p.numel() for p in model.parameters()) / 1e6:.2f} M "
        f"parameters, {len(buffers)} running statistics, built in "
        f"{time.perf_counter() - t0:.1f} s; B={RESNET_BATCH} "
        f"{RESNET_HW}x{RESNET_HW}, bf16 over fp32 masters, lr {RESNET_LR}, "
        f"momentum {RESNET_MOMENTUM}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in COUNTERS.values():
        c.reset()
    # -- the main path: counters at 0 before, read right after --------------
    losses = []
    t0 = time.perf_counter()
    state, loss = step(state, x, y)  # warm-up
    losses.append(loss)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    mem = torch.cuda.max_memory_allocated()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    e0.record()
    for _ in range(RESNET_STEPS):
        state, loss = step(state, x, y)
        losses.append(loss)
    e1.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / RESNET_STEPS
    launches = {n: c.value for n, c in COUNTERS.items()}
    # ------------------------------------------------------------------------
    step_ms = e0.elapsed_time(e1) / RESNET_STEPS
    MEASURED["resnet_step_ms"] = step_ms
    losses = [float(v) for v in losses]
    log(f"losses: {' '.join(f'{v:.4f}' for v in losses)}")
    # the path is cuDNN and ATen: no hand-written kernel launches
    _expect_launches(launches, 0, (), f"{RESNET_STEPS + 1} ResNet steps")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError("ResNet losses are not finite and falling")
    if not all(bool(torch.isfinite(v).all()) for v in state["vel"].values()):
        raise AssertionError("a ResNet velocity is not finite")
    if not all(bool(torch.isfinite(state["params"][k]).all())
               for k in buffers):
        raise AssertionError("a running statistic is not finite")
    moved = sum(not torch.equal(state["params"][k], stats0[k])
                for k in buffers)
    if moved != len(buffers):
        raise AssertionError(f"only {moved} of {len(buffers)} running "
                             f"statistics moved")
    flops = 3 * VT.resnet50_fwd_flops(RESNET_BATCH, RESNET_HW,
                                      RESNET_CLASSES)
    summary = dict(step_ms=step_ms, host_step_ms=host_ms,
                   images_per_s=RESNET_BATCH / (step_ms / 1e3),
                   step_flops=flops,
                   mfu=flops / (step_ms / 1e3) / PEAK_BF16_FLOPS,
                   warmup_step_s=warm_s, max_memory_allocated_bytes=mem,
                   losses=losses, cudnn_benchmark=True)
    log(f"resnet50 train step B={RESNET_BATCH}: {step_ms:.3f} ms (CUDA "
        f"events; host clock {host_ms:.3f} ms), "
        f"{summary['images_per_s']:.1f} images/s, MFU "
        f"{100 * summary['mfu']:.2f}% of 989 TFLOP/s ({flops / 1e12:.3f} "
        f"TFLOP a step, 3 x resnet50_fwd_flops), warm-up step {warm_s:.2f} "
        f"s, max_memory_allocated {mem / 2 ** 30:.2f} GiB")
    busy, wall, top = _profile(lambda: step(state, x, y), top=12)
    summary.update(profiled_busy_ms=busy, profiled_wall_ms=wall,
                   profiled_idle=max(0.0, 1 - busy / wall),
                   top_kernels=[dict(name=k[:90], ms=ms, count=n)
                                for k, ms, n in top])
    del model, step, state, x, y
    torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = False
    summary["resnet18_f32_check"] = _resnet_check()
    summary["card"] = card_line()
    log("resnet summary: " + json.dumps(summary))
    return launches


def _fluid_state_errors(card_scope, cpu_scope):
    """Relative L2 error of every float var of the card's scope against
    the CPU's, an all-noise var counted as 1e-6 an element."""
    out = {}
    for n in cpu_scope.local_var_names():
        want = cpu_scope.get(n).double()
        if not want.is_floating_point():
            continue
        got = card_scope.get(n).double().cpu()
        floor = 1e-6 * max(want.numel(), 1) ** 0.5
        out[n] = float((got - want).norm()) / max(float(want.norm()), floor)
    return out


def _fluid_cpu_check(fluid, R):
    """resnet18 (width 8, B=8, 32 x 32, the default Momentum + L2Decay)
    on the card's Executor against the CPU's, from the same startup
    values, 3 steps, each from the CPU's state: the loss within
    FLUID_LOSS_RTOL, every float state var within RESNET_KINK."""
    from paddle_tpu_torch.convert import load_jax_scope
    from paddle_tpu_torch.fluid import unique_name

    with unique_name.guard():
        main, startup, _, fetches = R.build_train_program(
            depth=18, class_num=10, image_shape=(3, 32, 32), batch_size=8,
            width=8)
    rng = np.random.RandomState(0)
    feed = {"image": rng.rand(8, 3, 32, 32).astype("float32"),
            "label": rng.randint(0, 10, (8, 1)).astype("int64")}
    gpu, cpu = fluid.Executor(), fluid.Executor(fluid.CPUPlace())
    gs, cs = fluid.Scope(), fluid.Scope()
    gpu.run(startup, scope=gs)
    cpu.run(startup, scope=cs)
    load_jax_scope(cs, {n: gs.get(n).cpu().numpy()
                        for n in gs.local_var_names()})
    worst_loss, worst_state, losses = 0.0, {}, []
    for i in range(3):
        load_jax_scope(gs, {n: cs.get(n).numpy()
                            for n in cs.local_var_names()})
        g_loss, g_acc = gpu.run(main, feed=feed, fetch_list=fetches,
                                scope=gs)
        c_loss, c_acc = cpu.run(main, feed=feed, fetch_list=fetches,
                                scope=cs)
        rel = abs(float(g_loss) - float(c_loss)) / abs(float(c_loss))
        worst_loss = max(worst_loss, rel)
        losses.append((float(g_loss), float(c_loss)))
        for n, e in _fluid_state_errors(gs, cs).items():
            worst_state[n] = max(worst_state.get(n, 0.0), e)
        if not rel <= FLUID_LOSS_RTOL or not np.isfinite(float(g_loss)):
            raise AssertionError(f"resnet18 step {i}: card loss {g_loss} vs "
                                 f"CPU {c_loss}")
    name, err = max(worst_state.items(), key=lambda kv: kv[1])
    if err > RESNET_KINK:
        raise AssertionError(f"resnet18 static: {name} relative L2 {err}")
    log(f"static resnet18 (width 8, B=8, f32): card vs CPU Executor over 3 "
        f"steps from the same state: losses {losses}, worst loss error "
        f"{worst_loss:.3g} (limit {FLUID_LOSS_RTOL}), worst state var "
        f"{name} {err:.3g} (limit {RESNET_KINK}) of {len(worst_state)}")
    # the Executor's own host time an op, where the device waits on the
    # host: this small program's steps, fed from the card
    dev_feed = {k: torch.from_numpy(v).cuda() for k, v in feed.items()}
    n_ops = len(main.global_block().ops)

    def step():
        return gpu.run(main, feed=dev_feed, fetch_list=fetches, scope=gs,
                       return_numpy=False)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / 10
    log(f"static resnet18 step on the card, host-bound: {host_ms:.3f} ms "
        f"for {n_ops} ops, {1e3 * host_ms / n_ops:.1f} us an op (host "
        f"clock, 10 steps)")
    return dict(worst_loss_rel=worst_loss, worst_state=name,
                worst_state_rel_l2=err, losses=losses,
                host_bound_step_ms=host_ms, ops_per_step=n_ops,
                host_us_per_op=1e3 * host_ms / n_ops)


def _fluid_mnist(fluid):
    """BASELINE configs[0] (models/mnist.py, Adam lr 1e-3) on the card:
    MNIST_STEPS steps on one batch, finite and falling."""
    from paddle_tpu_torch.fluid import unique_name
    from paddle_tpu_torch.models import mnist

    with unique_name.guard():
        main, startup, _, fetches = mnist.build_train_program()
    rng = np.random.RandomState(0)
    feed = {"img": torch.from_numpy(rng.rand(MNIST_BATCH, 1, 28, 28)
                                    .astype("float32")).cuda(),
            "label": torch.from_numpy(rng.randint(0, 10, (MNIST_BATCH, 1))
                                      .astype("int64")).cuda()}
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    out = [exe.run(main, feed=feed, fetch_list=fetches, scope=scope,
                   return_numpy=False)[0] for _ in range(MNIST_STEPS)]
    losses = [float(v) for v in out]
    log(f"static MNIST (Adam) B={MNIST_BATCH}: losses "
        f"{' '.join(f'{v:.4f}' for v in losses)}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError("MNIST losses are not finite and falling")
    return losses


@phase("fluid")
def fluid_resnet():
    """The Fluid static graph: BASELINE configs[1]'s train program
    (models/resnet.build_train_program at its defaults: ResNet-50, 1000
    classes, 224^2, B=128, Momentum lr 0.1 + L2Decay 1e-4, f32) built
    with the port's fluid, its startup run on the card, then 1 warm-up
    and FLUID_TIMED steps timed by CUDA events under
    set_sync_debug_mode("error") with return_numpy=False, and more steps
    to step FLUID_STEPS + 1 where the falling loss is read; one step
    profiled.  Then resnet18 on the card against the CPU Executor, and
    MNIST with Adam."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import unique_name
    from paddle_tpu_torch.models import resnet as R

    torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = True
    t0 = time.perf_counter()
    with unique_name.guard():
        main, startup, feeds, fetches = R.build_train_program(
            depth=50, class_num=FLUID_CLASSES,
            image_shape=(3, FLUID_HW, FLUID_HW), batch_size=FLUID_BATCH)
    block = main.global_block()
    n_ops = len(block.ops)
    params = [p for p in main.all_parameters() if p.trainable]
    n_params = sum(int(np.prod(p.shape)) for p in params)
    built_s = time.perf_counter() - t0
    exe, scope = fluid.Executor(), fluid.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    stats = [n for n in scope.local_var_names()
             if n.endswith((".w_1", ".w_2")) and n.startswith("batch_norm")]
    stats0 = {n: scope.get(n).clone() for n in stats}
    rng = np.random.RandomState(0)
    feed = {"image": torch.from_numpy(rng.randn(
                FLUID_BATCH, 3, FLUID_HW, FLUID_HW).astype("float32")).cuda(),
            "label": torch.from_numpy(rng.randint(
                0, FLUID_CLASSES, (FLUID_BATCH, 1)).astype("int64")).cuda()}
    log(f"static resnet50: {len(params)} parameters ({n_params / 1e6:.2f} "
        f"M), {len(stats)} running statistics, {n_ops} ops a step "
        f"(program built in {built_s:.1f} s, startup run on the card in "
        f"{startup_s:.2f} s); B={FLUID_BATCH} {FLUID_HW}x{FLUID_HW} f32, "
        f"Momentum lr 0.1 + L2Decay 1e-4")

    def run():
        return exe.run(main, feed=feed, fetch_list=fetches, scope=scope,
                       return_numpy=False)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    profiler.stat_reset()
    profiler.time_reset()
    for c in COUNTERS.values():
        c.reset()
    # -- the main path: counters at 0 before, read right after --------------
    out = []
    t0 = time.perf_counter()
    out.append(run())  # warm-up (cuDNN's algorithm search)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    dispatch0 = profiler.get_time_stats().get("dispatch_ms", 0.0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        h0 = time.perf_counter()
        e0.record()
        for _ in range(FLUID_TIMED):
            out.append(run())
        e1.record()
        host_s = time.perf_counter() - h0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    timed_stats = profiler.get_int_stats()
    dispatch_ms = profiler.get_time_stats()["dispatch_ms"] - dispatch0
    for _ in range(FLUID_STEPS - FLUID_TIMED):
        out.append(run())
    torch.cuda.synchronize()
    mem = torch.cuda.max_memory_allocated()
    launches = {n: c.value for n, c in COUNTERS.items()}
    stats_all = profiler.get_int_stats()
    # ------------------------------------------------------------------------
    step_ms = e0.elapsed_time(e1) / FLUID_TIMED
    host_ms = host_s * 1e3 / FLUID_TIMED
    losses = [float(o[0]) for o in out]
    accs = [float(o[1]) for o in out]
    log(f"losses: {' '.join(f'{v:.4f}' for v in losses)}")
    _expect_launches(launches, 0, (), f"{len(out)} static ResNet steps")
    if timed_stats.get("executor_sync_count", 0):
        raise AssertionError(f"{timed_stats['executor_sync_count']} syncs "
                             f"counted in the timed steps")
    want_ops = n_ops * len(out)
    if stats_all.get("executor_op_count") != want_ops \
            or stats_all.get("executor_run_count") != len(out) \
            or stats_all.get("executor_compile_count") != 1:
        raise AssertionError(f"executor counters {stats_all} (want "
                             f"{want_ops} ops in {len(out)} runs, 1 build)")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError("static ResNet losses are not finite and "
                             "falling")
    vel = [n for n in scope.local_var_names() if n.endswith("_velocity_0")]
    if len(vel) != len(params) or not all(
            bool(torch.isfinite(scope.get(n)).all()) for n in vel):
        raise AssertionError("a velocity is missing or not finite")
    moved = sum(not torch.equal(scope.get(n), stats0[n]) for n in stats)
    if moved != len(stats) or not all(
            bool(torch.isfinite(scope.get(n)).all()) for n in stats):
        raise AssertionError(f"only {moved} of {len(stats)} running "
                             f"statistics moved (or one is not finite)")
    flops = 3 * VT.resnet50_fwd_flops(FLUID_BATCH, FLUID_HW, FLUID_CLASSES)
    summary = dict(
        step_ms=step_ms, host_step_ms=host_ms,
        host_dispatch_ms_per_op=dispatch_ms / FLUID_TIMED / n_ops,
        images_per_s=FLUID_BATCH / (step_ms / 1e3), step_flops=flops,
        mfu_bf16_peak=flops / (step_ms / 1e3) / PEAK_BF16_FLOPS,
        mfu_f32_peak=flops / (step_ms / 1e3) / PEAK_F32_FLOPS,
        ops_per_step=n_ops, parameters=n_params, warmup_step_s=warm_s,
        startup_s=startup_s, max_memory_allocated_bytes=mem,
        losses=losses, accuracies=accs, syncs_in_timed_steps=0,
        cudnn_benchmark=True)
    log(f"static resnet50 train step B={FLUID_BATCH} f32: {step_ms:.3f} ms "
        f"(CUDA events; host clock {host_ms:.3f} ms, dispatch "
        f"{summary['host_dispatch_ms_per_op'] * 1e3:.1f} us an op over "
        f"{n_ops} ops, waits on the device included), "
        f"{summary['images_per_s']:.1f} images/s, MFU "
        f"{100 * summary['mfu_bf16_peak']:.2f}% of 989 TFLOP/s "
        f"({100 * summary['mfu_f32_peak']:.2f}% of the 67 TFLOP/s f32 "
        f"peak; {flops / 1e12:.3f} TFLOP a step), warm-up step "
        f"{warm_s:.2f} s, max_memory_allocated {mem / 2 ** 30:.2f} GiB; "
        f"0 syncs in {FLUID_TIMED} steps (sync debug mode 'error')")
    busy, wall, top = _profile(lambda: run()[0].torch(), top=12)
    summary.update(profiled_busy_ms=busy, profiled_wall_ms=wall,
                   profiled_idle=max(0.0, 1 - busy / wall),
                   top_kernels=[dict(name=k[:90], ms=ms, count=n)
                                for k, ms, n in top])
    del out, feed, scope, exe
    torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = False
    summary["resnet18_card_vs_cpu"] = _fluid_cpu_check(fluid, R)
    summary["mnist_losses"] = _fluid_mnist(fluid)
    summary["card"] = card_line()
    log("fluid summary: " + json.dumps(summary))
    return launches


def wmt_step_flops(cfg, batch, src, tgt):
    """Model FLOPs of one WMT train step, 3x the forward's matmul and
    attention products: per source token and encoder layer the q/k/v/o
    and FFN products and QK^T, PV over S keys; per target token and
    decoder layer the self-attention's q/k/v/o, the cross-attention's q
    and o, the FFN, and QK^T, PV over T and over S keys; per source token
    and decoder layer the cross-attention's k and v of the memory; per
    target token the output projection to the vocabulary."""
    d, f, v = cfg.d_model, cfg.d_inner_hid, cfg.tgt_vocab_size
    enc = cfg.num_encoder_layers * (2 * (4 * d * d + 2 * d * f)
                                    + 4 * src * d)
    dec = cfg.num_decoder_layers * (2 * (6 * d * d + 2 * d * f)
                                    + 4 * (tgt + src) * d)
    memory_kv = cfg.num_decoder_layers * 2 * 2 * d * d
    fwd = batch * (src * (enc + memory_kv) + tgt * (dec + 2 * d * v))
    return 3 * fwd


def _wmt_train(W, cfg):
    """Transformer-base through build_train_step (bf16 over fp32 masters,
    dropout 0.1, Noam warm-up WMT_WARMUP) on the FFN's default arm: 1
    warm-up and WMT_TIMED steps timed by CUDA events under
    set_sync_debug_mode("error"), the counters at 0 just before and read
    just after (the main path), more steps to WMT_STEPS, one profiled,
    then one step with the kernel arm opened.  Returns (summary,
    launches)."""
    t0 = time.perf_counter()
    model = W.WMTTransformer(cfg, seed=0)  # f32, train() mode
    n_params = sum(p.numel() for p in model.parameters())
    step, state = W.build_train_step(model, warmup_steps=WMT_WARMUP)
    fb = W.fake_batch(cfg, WMT_BATCH, WMT_SRC, WMT_TGT, seed=13)
    batch = {k: torch.from_numpy(v).cuda() for k, v in fb.items()}
    start = {k: v.clone() for k, v in state["params"].items()}
    log(f"WMTTransformer(base): {n_params / 1e6:.2f} M parameters, "
        f"{len(state['params'])} state tensors (the 2 position tables "
        f"included), built in {time.perf_counter() - t0:.1f} s; B="
        f"{WMT_BATCH} S={WMT_SRC} T={WMT_TGT}, dropout {cfg.dropout}, "
        f"Noam warm-up {WMT_WARMUP}; FFN arm "
        f"{F._ffn_arm([torch.bfloat16] * 5, cfg.d_model, cfg.d_inner_hid)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in COUNTERS.values():
        c.reset()
    for name in ("ffn_dispatch_kernel", "ffn_dispatch_library",
                 "attention_dispatch_dense"):
        profiler.stat_reset(name)
    # -- the main path: counters at 0 before, read right after --------------
    losses = []
    t0 = time.perf_counter()
    state, loss = step(state, batch)  # warm-up
    losses.append(loss)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.set_sync_debug_mode("error")
    try:
        h0 = time.perf_counter()
        e0.record()
        for _ in range(WMT_TIMED):
            state, loss = step(state, batch)
            losses.append(loss)
        e1.record()
        host_ms = (time.perf_counter() - h0) * 1e3 / WMT_TIMED
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = {n: c.value for n, c in COUNTERS.items()}
    stats = profiler.get_int_stats()
    mem = torch.cuda.max_memory_allocated()
    # ------------------------------------------------------------------------
    steps = WMT_TIMED + 1
    step_ms = e0.elapsed_time(e1) / WMT_TIMED
    _expect_launches(launches, 2 * WMT_LAYERS * steps, LIBRARY_TRAIN_KERNELS,
                     f"{steps} WMT steps")
    dispatch = {k: stats.get(k, 0) for k in (
        "ffn_dispatch_kernel", "ffn_dispatch_library",
        "attention_dispatch_dense")}
    want = {"ffn_dispatch_kernel": 0,
            "ffn_dispatch_library": 2 * WMT_LAYERS * steps,
            "attention_dispatch_dense": WMT_LAYERS * steps}
    log(f"kernel launches on the main path ({steps} steps): {launches}; "
        f"dispatch {dispatch}")
    if dispatch != want:
        raise AssertionError(f"WMT dispatch {dispatch} (want {want})")
    while len(losses) < WMT_STEPS:
        state, loss = step(state, batch)
        losses.append(loss)
    losses = [float(x) for x in losses]
    log(f"losses: {' '.join(f'{x:.4f}' for x in losses)}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"WMT losses are not finite and falling by "
                             f"step {WMT_STEPS}")
    if not all(bool(torch.isfinite(state[s][k]).all())
               for s in ("m", "v") for k in state[s]):
        raise AssertionError("a WMT gradient holds a NaN or inf (moments)")
    # every tensor moves but the k_proj biases, whose exact gradient is 0
    # (softmax ignores a score added to every key of a query)
    still = [k for k, v in state["params"].items()
             if torch.equal(v, start[k]) and not k.endswith("k_proj.bias")]
    pe_moved = {k: float((state["params"][k] - start[k]).abs().max())
                for k in ("src_pos.pe", "tgt_pos.pe")}
    log(f"position tables moved by {pe_moved}; tensors that did not move: "
        f"{still}")
    if still or not all(m > 0 for m in pe_moved.values()):
        raise AssertionError(f"parameters did not move: {still} {pe_moved}")
    flops = wmt_step_flops(cfg, WMT_BATCH, WMT_SRC, WMT_TGT)
    summary = dict(
        step_ms=step_ms, host_step_ms=host_ms, warmup_step_s=warm_s,
        src_tokens_per_s=WMT_BATCH * WMT_SRC / (step_ms / 1e3),
        tgt_tokens_per_s=WMT_BATCH * WMT_TGT / (step_ms / 1e3),
        step_flops=flops, mfu=flops / (step_ms / 1e3) / PEAK_BF16_FLOPS,
        max_memory_allocated_bytes=mem, parameters=n_params, losses=losses,
        position_tables_moved=pe_moved, syncs_in_timed_steps=0)
    log(f"WMT train step B={WMT_BATCH} S={WMT_SRC} T={WMT_TGT}: "
        f"{step_ms:.3f} ms (CUDA events; host clock {host_ms:.3f} ms), "
        f"{summary['src_tokens_per_s']:.0f} source / "
        f"{summary['tgt_tokens_per_s']:.0f} target tokens/s, MFU "
        f"{100 * summary['mfu']:.2f}% of 989 TFLOP/s ({flops / 1e12:.4f} "
        f"TFLOP a step), warm-up step {warm_s:.2f} s, max_memory_allocated "
        f"{mem / 2 ** 30:.2f} GiB; 0 syncs in {WMT_TIMED} steps")
    busy, wall, top = _profile(lambda: step(state, batch), top=15)
    summary.update(profiled_busy_ms=busy, profiled_wall_ms=wall,
                   profiled_idle=max(0.0, 1 - busy / wall),
                   top_kernels=[dict(name=k[:90], ms=ms, count=n)
                                for k, ms, n in top])
    # one step on the FFN's kernel arm, opened as a user opts in
    F.enable_fused_ffn()
    for c in COUNTERS.values():
        c.reset()
    state, loss = step(state, batch)
    torch.cuda.synchronize()
    opted = {n: c.value for n, c in COUNTERS.items()}
    _expect_launches(opted, 2 * WMT_LAYERS, TRAIN_KERNELS,
                     "one WMT step on the kernel arm")
    if not np.isfinite(float(loss)):
        raise AssertionError("the kernel-arm WMT step's loss is not finite")
    log(f"one step on the kernel arm: loss {float(loss):.4f}, launches "
        f"{opted}")
    summary["kernel_arm_launches"] = opted
    return summary, launches


def _wmt_decode(W, cfg):
    """Transformer-base in bf16 (eval) decoding WMT_DECODE_BATCH sources
    of WMT_SRC tokens for WMT_MAX_LEN steps: greedy, beams of WMT_BEAM
    and of 1, in that order under set_sync_debug_mode("error"), the
    counters at 0 just before and read just after each.  Returns
    (summary, launches)."""
    model = W.WMTTransformer(cfg, dtype=torch.bfloat16, seed=1).eval()
    src = torch.from_numpy(W.fake_batch(cfg, WMT_DECODE_BATCH, WMT_SRC, 1,
                                        seed=17)["src"]).cuda()
    n = WMT_DECODE_BATCH * WMT_MAX_LEN
    model.greedy_decode(src, 2)  # warm-up
    model.beam_decode(src, WMT_BEAM, 2)
    with torch.no_grad():
        enc_ms = time_ms(lambda: model._encode(src), iters=5, warmup=1)
    torch.cuda.synchronize()
    for c in COUNTERS.values():
        c.reset()
    profiler.stat_reset("attention_dispatch_dense")
    # -- the main path: counters at 0 before, read right after each ---------
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    counts = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        ev[0].record()
        greedy = model.greedy_decode(src, WMT_MAX_LEN)
        ev[1].record()
        counts.append({n_: c.value for n_, c in COUNTERS.items()})
        seqs4, scores4 = model.beam_decode(src, WMT_BEAM, WMT_MAX_LEN)
        ev[2].record()
        counts.append({n_: c.value for n_, c in COUNTERS.items()})
        seqs1, scores1 = model.beam_decode(src, 1, WMT_MAX_LEN)
        ev[3].record()
        counts.append({n_: c.value for n_, c in COUNTERS.items()})
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    dense = profiler.get_int_stats().get("attention_dispatch_dense", 0)
    # ------------------------------------------------------------------------
    launches = counts[-1]
    per_call = {"flash_fwd": WMT_LAYERS + 2 * WMT_LAYERS * WMT_MAX_LEN,
                "ffn_act_fwd": WMT_LAYERS + WMT_LAYERS * WMT_MAX_LEN}
    for i, c in enumerate(counts):
        got = {k: v for k, v in c.items() if v}
        want = {k: (i + 1) * v for k, v in per_call.items()}
        if got != want:
            raise AssertionError(f"decode launches {got} after call {i + 1} "
                                 f"(want {want}: 6 for the encoder, 12 "
                                 f"flash_fwd and 6 ffn_act_fwd a step)")
    if dense:
        raise AssertionError(f"{dense} attention calls in the decode loops "
                             f"went to the dense path")
    ms = {"greedy": ev[0].elapsed_time(ev[1]),
          f"beam{WMT_BEAM}": ev[1].elapsed_time(ev[2]),
          "beam1": ev[2].elapsed_time(ev[3])}
    if not torch.equal(greedy, seqs1[:, 0]):
        raise AssertionError("greedy and beam 1 disagree")
    s1, s4 = scores1[:, 0].float().cpu(), scores4.float().cpu()
    if not (bool(torch.isfinite(s4).all())
            and bool((s4[:, 1:] - s4[:, :-1] <= 1e-5).all())):
        raise AssertionError(f"beam {WMT_BEAM} scores not finite and best "
                             f"first: {s4.tolist()}")
    if tuple(seqs4.shape) != (WMT_DECODE_BATCH, WMT_BEAM, WMT_MAX_LEN):
        raise AssertionError(f"beam sequences of shape {tuple(seqs4.shape)}")
    # beam search is not monotone in its width: a wider beam may drop the
    # greedy path for prefixes that score better and end worse (on these
    # random weights one source of 8 ends 0.18 below greedy on the H100,
    # PERF.md §6).  Where greedy's sequence
    # is still one of the final beams, beam W's best must be at least its
    # score, which is greedy's: a row's arithmetic does not depend on the
    # other rows of its batch
    kept = (seqs4.cpu() == greedy.cpu()[:, None]).all(dim=-1).any(dim=-1)
    gain = (s4[:, 0] - s1).tolist()
    log(f"beam {WMT_BEAM} best - beam 1, by source: "
        f"{' '.join(f'{x:+.4f}' for x in gain)}; greedy's sequence among "
        f"the final beams of sources {kept.nonzero()[:, 0].tolist()}")
    if not bool((s4[:, 0] >= s1 - 1e-5)[kept].all()):
        raise AssertionError(f"beam {WMT_BEAM} scores below greedy's where "
                             f"greedy's sequence is a final beam: {gain}")
    # teacher forcing: a full forward over BOS + the greedy tokens before
    # each position; the chosen token's logit within DECODE_LOGIT_TOL of
    # the largest there
    prefix = torch.cat([torch.full_like(greedy[:, :1], cfg.bos_id),
                        greedy[:, :-1]], dim=1)
    with torch.no_grad():
        logits = model(src, prefix).float()
    chosen = logits.gather(-1, greedy[..., None])[..., 0]
    gap = float((logits.max(dim=-1).values - chosen).max())
    agree = float((logits.argmax(dim=-1) == greedy).float().mean())
    log(f"teacher forcing: largest logit - chosen logit at most {gap:.4f} "
        f"(tolerance {DECODE_LOGIT_TOL}; |logits| up to "
        f"{float(logits.abs().max()):.3f}), argmax agrees at "
        f"{100 * agree:.1f}% of {n} positions")
    if gap > DECODE_LOGIT_TOL:
        raise AssertionError("greedy tokens fail the teacher-forced check")
    summary = dict(encoder_ms=enc_ms, launches_per_call=per_call,
                   teacher_forced_gap=gap, argmax_agreement=agree,
                   best_scores={"beam1": s1.tolist(),
                                f"beam{WMT_BEAM}": s4[:, 0].tolist()},
                   greedy_among_final_beams=kept.tolist())
    for key, total in ms.items():
        summary[key] = dict(ms=total,
                            step_ms=(total - enc_ms) / WMT_MAX_LEN,
                            tokens_per_s=n / (total / 1e3))
        log(f"{key} decode of {WMT_DECODE_BATCH} x {WMT_SRC} -> "
            f"{WMT_MAX_LEN} tokens: {total:.2f} ms "
            f"({summary[key]['step_ms']:.3f} ms a step after the "
            f"encoder's {enc_ms:.2f} ms), "
            f"{summary[key]['tokens_per_s']:.0f} tokens/s; 0 syncs")
    busy, wall, _ = _profile(lambda: model.greedy_decode(src, WMT_MAX_LEN),
                             top=8)
    summary.update(greedy_profiled_busy_ms=busy,
                   greedy_profiled_wall_ms=wall,
                   greedy_profiled_idle=max(0.0, 1 - busy / wall))
    return summary, launches


@phase("wmt")
def wmt():
    """BASELINE.json configs[2], the Transformer-base WMT en-de model:
    training on the FFN's default arm (and one step on its kernel arm),
    then greedy and beam decoding.  Returns {"wmt_train": launches,
    "wmt_decode": launches}."""
    from paddle_tpu_torch.models import transformer_wmt as W

    torch.cuda.empty_cache()
    cfg = W.TransformerConfig.base()
    F.disable_fused_ffn("the reference's default: the library arm")
    try:
        train, train_launches = _wmt_train(W, cfg)
        F.disable_fused_ffn("the reference's default: the library arm")
        torch.cuda.empty_cache()
        decode, decode_launches = _wmt_decode(W, cfg)
    finally:
        F.enable_fused_ffn()
    log("wmt summary: " + json.dumps(dict(train=train, decode=decode,
                                          card=card_line())))
    return {"wmt_train": train_launches, "wmt_decode": decode_launches}


@phase("check")
def reference_check():
    cfg = bert.BertConfig.base(num_hidden_layers=2)
    gpu = bert.BertModel(cfg, dtype=torch.bfloat16, seed=1).eval()
    cpu = bert.BertModel(cfg, device="cpu", seed=1).eval()
    fb = bert.fake_batch(cfg, 2, 128, seed=3)
    am = (fb["attention_mask"] != 0)[:, None, None, :]
    args = [torch.from_numpy(a) for a in (fb["input_ids"],
                                          fb["token_type_ids"], am)]
    with torch.inference_mode():
        g_enc, g_pooled = gpu(args[0].cuda(), args[1].cuda(),
                              attention_mask=args[2].cuda())
        c_enc, c_pooled = cpu(args[0], args[1], attention_mask=args[2])
    for name, g, c in (("encoded", g_enc, c_enc), ("pooled", g_pooled,
                                                   c_pooled)):
        err = (g.float().cpu() - c).abs()
        log(f"{name}: card bf16 vs CPU f32 max abs {float(err.max()):.4g} "
            f"mean abs {float(err.mean()):.4g}")
        if not torch.isfinite(g).all() or float(err.max()) > REF_MAX_ABS \
                or float(err.mean()) > REF_MEAN_ABS:
            raise AssertionError(f"{name} disagrees with the CPU reference")


class _Images(pio.Dataset):
    """`n` uint8 CHW images and int64 labels from RandomState(seed); an
    item is the image as float32, scaled to [0, 1] and normalised by
    ImageNet's channel means and deviations, and its (1,) label."""

    MEAN = np.array([0.485, 0.456, 0.406], np.float32).reshape(3, 1, 1)
    STD = np.array([0.229, 0.224, 0.225], np.float32).reshape(3, 1, 1)

    def __init__(self, n, hw, classes, seed=0):
        rng = np.random.RandomState(seed)
        self.images = rng.randint(0, 256, (n, 3, hw, hw), dtype=np.uint8)
        self.labels = rng.randint(0, classes, (n, 1)).astype(np.int64)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        x = self.images[i].astype(np.float32) * np.float32(1 / 255)
        return (x - self.MEAN) / self.STD, self.labels[i]


class _StepClock(hcb.Callback):
    """CUDA events and the host clock at the end of every train step;
    from the second step on, every host sync, by the line that made it
    (torch.cuda.set_sync_debug_mode("warn"))."""

    def __init__(self):
        self.events, self.host, self.losses = [], [], []
        self.begin, self.issued = [], []
        self._catch = self.syncs = None

    def watch(self, model):
        """Also note when a step has issued its work: the host clock as
        train_batch hands the outputs to the metrics (its first sync)."""
        update = model._update_metrics

        def timed(*a):
            self.issued.append(time.perf_counter())
            return update(*a)

        model._update_metrics = timed
        return self

    def breakdown(self, first=1):
        """Mean host ms a step from step `first` on: issuing the step
        (train_batch up to its first sync), then the rest (the syncs'
        wait, metrics, callbacks, the next batch)."""
        issue = [i - b for b, i in zip(self.begin, self.issued)][first:]
        step = np.diff(self.host)[first - 1:]
        return dict(issue_ms=1e3 * float(np.mean(issue)),
                    rest_ms=1e3 * float(np.mean(step) - np.mean(issue)))

    def on_train_batch_begin(self, step, logs=None):
        self.begin.append(time.perf_counter())
        if step == 1:
            self._catch = warnings.catch_warnings(record=True)
            self.syncs = self._catch.__enter__()
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")

    def on_train_batch_end(self, step, logs=None):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events.append(e)
        self.host.append(time.perf_counter())
        self.losses.append(logs["loss"])

    def on_train_end(self, logs=None):
        torch.cuda.set_sync_debug_mode(0)
        if self._catch is not None:
            self._catch.__exit__(None, None, None)

    def sync_sites(self):
        return _sync_sites(self.syncs or [])


def _sync_sites(caught):
    """{file:line: count} of the host syncs among caught warnings."""
    sites = {}
    for w in caught:
        # the sync itself, not the notice that the first
        # set_sync_debug_mode of a process prints
        if "called a synchronizing" in str(w.message):
            key = f"{Path(w.filename).name}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    return sites


def _hapi_stages(model, x, y, steps=8):
    """Host ms a step of train_batch's stages (profiler.timed: issuing
    the forward, the backward, the update; the metrics, which wait for
    the device), over `steps` steps of one batch."""
    before = profiler.get_time_stats()
    for _ in range(steps):
        model.train_batch([x], [y])
    after = profiler.get_time_stats()
    out = {k: (after[k] - before.get(k, 0.0)) / steps for k in after
           if k.startswith("hapi_")}
    log(f"train_batch host ms a step by stage: "
        f"{ {k: round(v, 3) for k, v in out.items()} }")
    return out


def _host_ops(fn, top=12):
    """fn() once under torch.profiler (CPU only): the number of ops and
    the ones that took the most host time (self)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()]
    n = sum(e.count for e in events if e.key.startswith("aten::"))
    rows = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                   for e in events), reverse=True)[:top]
    log(f"host ops: {n} aten calls; by self host time:")
    for ms, count, key in rows:
        log(f"  {ms:8.3f} ms x{count:<5d} {key[:70]}")
    return dict(aten_calls=n, top=[dict(name=k[:70], ms=ms, count=c)
                                   for ms, c, k in rows])


def _loader_rate(ds, workers, batches):
    """Batches a second of the DataLoader alone (no model): `batches`
    batches of 128 to the card with the buffer reader, timed from the
    first batch to the last (the first's wait: the workers' start)."""
    loader = pio.DataLoader(ds, batch_size=RESNET_BATCH, shuffle=True,
                            drop_last=True, num_workers=workers,
                            use_buffer_reader=True)
    t0 = time.perf_counter()
    n = 0
    for _ in loader:
        n += 1
        if n == 1:
            t1 = time.perf_counter()
        if n == batches:
            break
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return dict(workers=workers, batches=n,
                first_batch_s=t1 - t0, batches_per_s=(n - 1) / (t2 - t1))


def _hapi_model(seed, amp="O1"):
    """resnet50 (seed) under a fresh unique_name guard (the parameter
    names, and so the optimizer's state keys, are the same for every
    model made here), Momentum over PiecewiseDecay with L2 1e-4."""
    with unique_name.guard():
        net = VM.resnet50(num_classes=RESNET_CLASSES, seed=seed)
    opt = poptim.Momentum(
        learning_rate=poptim.lr.PiecewiseDecay([HAPI_BOUNDARY],
                                               list(HAPI_LRS)),
        momentum=RESNET_MOMENTUM, weight_decay=HAPI_WD,
        parameters=net.parameters())
    model = paddle.Model(net)
    model.prepare(opt, pnn.CrossEntropyLoss(), pmetric.Accuracy(topk=(1, 5)),
                  amp_configs=amp)
    return model


def _hapi_eval_check(model, ds):
    """evaluate's top-1 and top-5 against a numpy recount of predict's
    logits on the same images: exactly."""
    logs = model.evaluate(ds, batch_size=RESNET_BATCH, verbose=0)
    (logits,) = model.predict(ds, batch_size=RESNET_BATCH,
                              stack_outputs=True)
    top = np.argsort(-logits, axis=-1)[:, :5]
    hit = top == ds.labels[: len(logits)]
    recount = [float(hit[:, :k].any(-1).mean()) for k in (1, 5)]
    got = [logs["acc_top1"], logs["acc_top5"]]
    log(f"evaluate on {len(logits)} images: loss {logs['loss']:.4f}, top-1 "
        f"{got[0]}, top-5 {got[1]}; numpy recount of predict's logits "
        f"{recount}")
    if got != recount or not np.isfinite(logits).all():
        raise AssertionError(f"evaluate {got} != recount {recount}")
    return dict(eval_loss=logs["loss"], top1=got[0], top5=got[1])


def _hapi_reload_check(model, batch):
    """Model.save, then Model.load into a fresh model (other weights):
    the same predictions, the same optimizer state, and the next
    train_batch's loss that of the saved model's (HAPI_RELOAD_RTOL)."""
    x, y = batch
    ckpt = Path(__file__).resolve().parent / "paddle_tpu_torch" / "_build"
    ckpt.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ckpt) as d:
        path = str(Path(d) / "hapi")
        t0 = time.perf_counter()
        model.save(path)
        save_s = time.perf_counter() - t0
        fresh = _hapi_model(seed=1)
        t0 = time.perf_counter()
        fresh.load(path)
        load_s = time.perf_counter() - t0
    pa, pb = model.predict_batch([x])[0], fresh.predict_batch([x])[0]
    if not np.array_equal(pa, pb):
        raise AssertionError(f"predictions after load differ by "
                             f"{np.abs(pa - pb).max()}")
    sa = model._optimizer.state_dict()
    sb = fresh._optimizer.state_dict()
    if sa.keys() != sb.keys() or sa["global_step"] != sb["global_step"] \
            or sa["LR_Scheduler"] != sb["LR_Scheduler"]:
        raise AssertionError("optimizer state keys or counters differ")
    for k, v in sa.items():
        if isinstance(v, torch.Tensor) and not torch.equal(v, sb[k]):
            raise AssertionError(f"optimizer state {k} differs")
    la = model.train_batch([x], [y])[0][0]
    lb = fresh.train_batch([x], [y])[0][0]
    if not (np.isfinite(la) and abs(la - lb) <= HAPI_RELOAD_RTOL * abs(la)):
        raise AssertionError(f"loss after load {lb} vs {la}")
    log(f"save {save_s:.2f} s, load {load_s:.2f} s: predictions bit for bit, "
        f"{len(sa) - 2} optimizer tensors equal, next loss {la:.6f} vs "
        f"{lb:.6f}")
    return dict(save_s=save_s, load_s=load_s, next_loss=[la, lb])


class _Losses(hcb.Callback):
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])


def _hapi_resnet18(dev, ds):
    """resnet18(num_classes=10) from seed 2 through Model.fit at f32
    (static-mode adapter, Momentum lr 0.01), 3 steps of B=4 on `dev`:
    the losses, the state after the fit and its change, on the CPU."""
    with unique_name.guard():
        net = VM.resnet18(num_classes=10, device=dev, seed=2)
    before = {k: v.detach().cpu().clone() for k, v in
              net.state_dict().items()}
    model = paddle.Model(net)
    model.prepare(poptim.Momentum(learning_rate=0.01, momentum=0.9,
                                  parameters=net.parameters()),
                  pnn.CrossEntropyLoss())
    cb = _Losses()
    model.fit(ds, batch_size=4, epochs=1, shuffle=False, verbose=0,
              callbacks=[cb])
    after = {k: v.detach().cpu() for k, v in net.state_dict().items()}
    return cb.losses, after, {k: v - before[k] for k, v in after.items()}


def _hapi_card_vs_cpu():
    """The resnet18 fit on the card against the CPU, as the comment above
    HAPI_RELOAD_RTOL states."""
    rng = np.random.RandomState(1)
    x = rng.randn(12, 3, 64, 64).astype("float32")
    y = rng.randint(0, 10, (12, 1)).astype("int64")
    one = pio.TensorDataset([x[:4], y[:4]])
    gpu, cpu = _hapi_resnet18("cuda", one), _hapi_resnet18("cpu", one)
    first = 0.0
    for k, d in cpu[2].items():
        if float(d.norm()) == 0.0:
            continue
        rel = float((gpu[2][k] - d).norm() / d.norm())
        first = max(first, rel)
        if not (rel <= RESNET_KINK and torch.isfinite(gpu[2][k]).all()):
            raise AssertionError(f"resnet18 fit, one step: the change of {k} "
                                 f"off by {rel} in relative L2")
    ds = pio.TensorDataset([x, y])
    gpu, cpu = _hapi_resnet18("cuda", ds), _hapi_resnet18("cpu", ds)
    g, c = np.array(gpu[0]), np.array(cpu[0])
    limit = (RESNET_TOL["atol"] + RESNET_TOL["rtol"] * np.abs(c)
             + RESNET_KINK * np.abs(c - c[0]))
    if not (np.isfinite(g).all() and (np.abs(g - c) <= limit).all()):
        raise AssertionError(f"resnet18 fit losses {g} vs {c}")
    state = max(float((gpu[1][k] - v).abs().max()) for k, v in cpu[1].items())
    change = max(float((gpu[2][k] - d).norm() / d.norm())
                 for k, d in cpu[2].items() if float(d.norm()) > 0.0)
    log(f"resnet18 Model.fit f32, card vs CPU: one step, each tensor's "
        f"change within {first:.3g} in relative L2 (limit {RESNET_KINK}); "
        f"3 steps, losses {g.tolist()} vs {c.tolist()} (limits "
        f"{limit.tolist()}); read only after 3 steps: the state's worst "
        f"abs error {state:.3g}, a change's worst relative L2 {change:.3g}")
    return dict(one_step_change_rel_l2=first, losses=g.tolist(),
                cpu_losses=c.tolist(), state_err=state,
                change_rel_l2=change)


@phase("hapi")
def hapi():
    """BASELINE.json configs[1], ResNet-50, through the 2.x front end:
    Model.fit over the port's DataLoader (HAPI_WORKERS process workers,
    the buffer reader), amp O1 on the static-mode adapter, Momentum over
    PiecewiseDecay with L2; the loader alone; one step profiled; the
    evaluate / predict, save / load and resnet18 card-vs-CPU checks."""
    torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = True  # the resnet phase's search
    t0 = time.perf_counter()
    ds = _Images(HAPI_IMAGES, RESNET_HW, RESNET_CLASSES)
    log(f"dataset: {HAPI_IMAGES} uint8 images 3x{RESNET_HW}x{RESNET_HW} "
        f"({ds.images.nbytes / 2 ** 20:.0f} MiB) in "
        f"{time.perf_counter() - t0:.1f} s")
    np.random.seed(0)
    rates = [_loader_rate(ds, w, 16) for w in (0, HAPI_WORKERS)]
    for r in rates:
        log(f"loader alone: {r['workers']} workers: "
            f"{r['batches_per_s']:.2f} batches/s after a first batch in "
            f"{r['first_batch_s']:.2f} s")
    model = _hapi_model(seed=0)
    loader = pio.DataLoader(ds, batch_size=RESNET_BATCH, shuffle=True,
                            drop_last=True, num_workers=HAPI_WORKERS,
                            use_buffer_reader=True)
    clock = _StepClock().watch(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in COUNTERS.values():
        c.reset()
    # -- the main path: counters at 0 before, read right after --------------
    model.fit(loader, epochs=1, verbose=1, log_freq=4,
              callbacks=[clock, hcb.ProgBarLogger(4, 1),
                         hcb.LRScheduler(by_step=True, by_epoch=False)])
    torch.cuda.synchronize()
    launches = {n: c.value for n, c in COUNTERS.items()}
    # ------------------------------------------------------------------------
    mem = torch.cuda.max_memory_allocated()
    steps = len(clock.events)
    _expect_launches(launches, 0, (), f"{steps} Model.fit steps")
    if steps != HAPI_IMAGES // RESNET_BATCH or not np.isfinite(
            clock.losses).all():
        raise AssertionError(f"{steps} steps, losses {clock.losses}")
    timed = steps - 1
    step_ms = clock.events[0].elapsed_time(clock.events[-1]) / timed
    host_ms = (clock.host[-1] - clock.host[0]) * 1e3 / timed
    sites = clock.sync_sites()
    flops = 3 * VT.resnet50_fwd_flops(RESNET_BATCH, RESNET_HW,
                                      RESNET_CLASSES)
    base = MEASURED.get("resnet_step_ms")
    summary = dict(
        steps=steps, step_ms=step_ms, host_step_ms=host_ms,
        images_per_s=RESNET_BATCH / (step_ms / 1e3),
        mfu=flops / (step_ms / 1e3) / PEAK_BF16_FLOPS,
        max_memory_allocated_bytes=mem, losses=clock.losses,
        lr_last=model._optimizer.get_lr(),
        syncs_per_step=sum(sites.values()) / timed, sync_sites=sites,
        resnet_phase_step_ms=base,
        ratio_to_resnet_phase=(step_ms / base) if base else None,
        loader=rates)
    log(f"losses: {' '.join(f'{v:.4f}' for v in clock.losses)}")
    log(f"hapi Model.fit ResNet-50 B={RESNET_BATCH} O1: {step_ms:.3f} ms a "
        f"step over steps 2-{steps} (CUDA events; host clock "
        f"{host_ms:.3f} ms), {summary['images_per_s']:.1f} images/s, MFU "
        f"{100 * summary['mfu']:.2f}%, max_memory_allocated "
        f"{mem / 2 ** 30:.2f} GiB; the resnet phase's step {base} ms "
        f"(ratio {summary['ratio_to_resnet_phase']}); host syncs a step "
        f"{summary['syncs_per_step']:.2f} at {sites}")
    summary.update(clock.breakdown())
    x, y = next(iter(pio.DataLoader(ds, batch_size=RESNET_BATCH,
                                    use_buffer_reader=True)))
    # the front end without the loader: one batch, already on the card
    staged = _StepClock().watch(model)
    model.fit([(x, y)] * 8, epochs=1, verbose=0, callbacks=[staged])
    torch.cuda.synchronize()
    staged_ms = staged.events[0].elapsed_time(staged.events[-1]) / 7
    summary.update(staged_step_ms=staged_ms,
                   staged=staged.breakdown(),
                   staged_syncs_per_step=sum(
                       staged.sync_sites().values()) / 7)
    log(f"the same fit over one staged batch (no loader): {staged_ms:.3f} "
        f"ms a step; host a step {staged.breakdown()} (with the loader "
        f"{clock.breakdown()})")
    summary["host_stages_ms"] = _hapi_stages(model, x, y)
    summary["host_ops"] = _host_ops(lambda: model.train_batch([x], [y]))
    # the resnet phase's hand-built step on the same module and batch, in
    # turns with train_batch (this process's host varies between phases)
    step, state = VT.build_train_step(model.network, lr=RESNET_LR,
                                      momentum=RESNET_MOMENTUM, bf16=True)
    state, _ = step(state, x, y[:, 0])
    turns = {"hand_built": [], "train_batch": []}
    runs = {"hand_built": lambda: step(state, x, y[:, 0]),
            "train_batch": lambda: model.train_batch([x], [y])}
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for name in ("hand_built", "train_batch") * 2:
        torch.cuda.synchronize()
        e0.record()
        for _ in range(8):
            runs[name]()
        e1.record()
        torch.cuda.synchronize()
        turns[name].append(e0.elapsed_time(e1) / 8)
    log(f"in turns on one staged batch, ms a step: {turns}")
    summary["turns_ms"] = turns
    summary["hand_built_host_ops"] = _host_ops(runs["hand_built"])
    del step, state, runs
    busy, wall, top = _profile(lambda: model.train_batch([x], [y]), top=8)
    summary.update(profiled_busy_ms=busy, profiled_wall_ms=wall,
                   profiled_idle=max(0.0, 1 - busy / wall),
                   top_kernels=[dict(name=k[:90], ms=ms, count=n)
                                for k, ms, n in top])
    summary["eval"] = _hapi_eval_check(
        model, _Images(HAPI_EVAL_IMAGES, RESNET_HW, RESNET_CLASSES, seed=1))
    summary["reload"] = _hapi_reload_check(model, (x, y))
    del model, loader, x, y
    torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = False
    summary["resnet18_f32_check"] = _hapi_card_vs_cpu()
    summary["card"] = card_line()
    log("hapi summary: " + json.dumps(summary))
    return launches


def _quickstart_batches(n_batches=40, batch=64, seed=0):
    """examples/quickstart_mnist.py's synthetic_batches."""
    r = np.random.RandomState(seed)
    for _ in range(n_batches):
        x = r.rand(batch, 1, 28, 28).astype("float32")
        y = r.randint(0, 10, (batch, 1)).astype("int64")
        yield x, y


def _lenet_first_step_cpu(x, y):
    """The quickstart's first dygraph step of LeNet (seed 0) on the CPU:
    loss and gradients."""
    net = VM.LeNet(device="cpu")
    loss = pF.cross_entropy(net(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    return float(loss), {n: p.grad for n, p in net.named_parameters()}


def _dygraph_1x_net():
    """A 1.x fluid.dygraph net at the quickstart's sizes:
    Conv2D(1, 6, 5, act="relu"), Pool2D(2, "max", 2), Linear(864, 10,
    act="softmax")."""
    from paddle_tpu_torch.fluid import dygraph

    class Net(dygraph.Layer):
        def __init__(self):
            super().__init__()
            self.conv = dygraph.Conv2D(1, 6, 5, act="relu")
            self.pool = dygraph.Pool2D(2, "max", 2)
            self.fc = dygraph.Linear(6 * 12 * 12, 10, act="softmax")

        def forward(self, x):
            return self.fc(paddle.flatten(self.pool(self.conv(x)), 1))

    return Net()


def _dygraph_1x_step(net, opt, x, y):
    """One step of the 1.x net: the loss (mean -log p of the label) as
    numpy and the gradients by name, then the update and
    clear_gradients()."""
    prob = net(paddle.to_tensor(x))
    loss = paddle.mean(-paddle.log(paddle.index_sample(prob,
                                                       paddle.to_tensor(y))))
    loss.backward()
    grads = {n: p.gradient() for n, p in net.named_parameters()}
    value = loss.numpy()
    opt.step()
    net.clear_gradients()
    return value, grads


def _dygraph_1x(x, y):
    """One step of the 1.x net on the card and on the CPU from the same
    weights (the loss and gradients within LENET_TOL), then a
    save_dygraph / load_dygraph round trip of its parameters and
    optimizer state into a fresh net and optimizer: the next step's loss
    equal."""
    from paddle_tpu_torch.fluid import dygraph

    nets = {}
    with unique_name.guard():
        start = _dygraph_1x_net()
    for dev in ("cuda", "cpu"):
        paddle.set_device(dev)
        try:
            with unique_name.guard():
                net = _dygraph_1x_net()
            net.set_state_dict({k: v.numpy() for k, v in
                                start.state_dict().items()})
            net = net.to(dev)
            opt = poptim.Adam(learning_rate=1e-3,
                              parameters=net.parameters())
            nets[dev] = (net, opt, _dygraph_1x_step(net, opt, x, y))
        finally:
            paddle.set_device("cuda")
    (loss_d, grads_d), (loss_c, grads_c) = (nets[d][2] for d in
                                            ("cuda", "cpu"))
    worst = float(abs(loss_d - loss_c))
    if not np.isfinite(loss_d) or worst > LENET_TOL["atol"] \
            + LENET_TOL["rtol"] * float(abs(loss_c)):
        raise AssertionError(f"1.x net loss {loss_d} vs CPU {loss_c}")
    for n, g in grads_c.items():
        ok, err = close(torch.from_numpy(grads_d[n]), torch.from_numpy(g),
                        **LENET_TOL)
        worst = max(worst, err)
        if not ok:
            raise AssertionError(f"1.x net gradient {n}: {err}")
    net, opt, _ = nets["cuda"]
    if any(p.grad is not None for p in net.parameters()):
        raise AssertionError("clear_gradients() left a gradient")
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "net")
        dygraph.save_dygraph(net.state_dict(), path)
        dygraph.save_dygraph(opt.state_dict(), path)
        params, opt_state = dygraph.load_dygraph(path)
    with unique_name.guard():
        fresh = _dygraph_1x_net().to("cuda")
    fresh.set_state_dict(params)
    fresh_opt = poptim.Adam(learning_rate=1e-3,
                            parameters=fresh.parameters())
    fresh_opt.set_state_dict(opt_state)
    loss_a, _ = _dygraph_1x_step(net, opt, x, y)
    loss_b, _ = _dygraph_1x_step(fresh, fresh_opt, x, y)
    if loss_a != loss_b:
        raise AssertionError(f"after load_dygraph: loss {loss_b} vs {loss_a}")
    log(f"1.x fluid.dygraph net (Conv2D relu, Pool2D, Linear softmax): card "
        f"vs CPU max abs error {worst:.3g} (limit {LENET_TOL}); "
        f"save_dygraph / load_dygraph: the next loss {float(loss_b):.6f} "
        f"equal ({len(params)} parameters, {len(opt_state)} optimizer "
        f"entries)")
    return worst


@phase("dygraph")
def dygraph_quickstart():
    """examples/quickstart_mnist.py's run_dygraph line for line (its
    `float(loss.numpy())` on a CUDA tensor) and run_hapi on the card
    through the port's names; the first dygraph step's loss and gradients
    against the CPU; one step of a 1.x fluid.dygraph net against the CPU
    and a save_dygraph / load_dygraph round trip."""
    from paddle_tpu_torch.fluid import dygraph

    for c in COUNTERS.values():
        c.reset()
    # -- run_dygraph ----------------------------------------------------------
    losses = []
    t0 = time.perf_counter()
    with dygraph.guard():
        net = VM.LeNet()
        opt = poptim.Adam(learning_rate=1e-3, parameters=net.parameters())
        for i, (x, y) in enumerate(_quickstart_batches()):
            logits = net(paddle.to_tensor(x))
            loss = pF.cross_entropy(logits, paddle.to_tensor(y))
            loss.backward()
            if i == 0:
                first = (float(loss.numpy()), {n: p.grad.cpu() for n, p in
                                               net.named_parameters()}, x, y)
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
            if i % 10 == 0:
                log(f"step {i}: loss {float(loss.numpy()):.4f}")
    dy_ms = (time.perf_counter() - t0) * 1e3 / len(losses)
    # -- run_hapi ---------------------------------------------------------------
    xs = np.concatenate([b[0] for b in _quickstart_batches(8)])
    ys = np.concatenate([b[1] for b in _quickstart_batches(8)])

    class Samples(pio.Dataset):
        def __len__(self):
            return len(xs)

        def __getitem__(self, i):
            return xs[i], ys[i]

    model = paddle.Model(VM.LeNet())
    model.prepare(poptim.Adam(learning_rate=1e-3,
                              parameters=model.parameters()),
                  pnn.CrossEntropyLoss(), pmetric.Accuracy())
    cb = _Losses()
    model.fit(Samples(), batch_size=64, epochs=1, verbose=1,
              callbacks=[cb, hcb.ProgBarLogger(10, 1)])
    # -- a 1.x fluid.dygraph net -------------------------------------------------
    with dygraph.guard():
        net_1x_err = _dygraph_1x(first[2], first[3])
    launches = {n: c.value for n, c in COUNTERS.items()}
    # ------------------------------------------------------------------------
    _expect_launches(launches, 0, (), "the quickstart's two modes")
    if not (np.isfinite(losses).all() and np.isfinite(cb.losses).all()
            and len(cb.losses) == 8):
        raise AssertionError(f"losses {losses} {cb.losses}")
    loss_c, grads_c = _lenet_first_step_cpu(first[2], first[3])
    worst = abs(first[0] - loss_c)
    if worst > LENET_TOL["atol"] + LENET_TOL["rtol"] * abs(loss_c):
        raise AssertionError(f"first loss {first[0]} vs CPU {loss_c}")
    for n, g in grads_c.items():
        ok, err = close(first[1][n], g, **LENET_TOL)
        worst = max(worst, err)
        if not ok:
            raise AssertionError(f"first-step gradient {n}: {err}")
    log(f"run_dygraph: 40 steps, {dy_ms:.2f} ms a step (host clock), "
        f"last loss {losses[-1]:.4f}; run_hapi: 8 steps, last loss "
        f"{cb.losses[-1]:.4f}; first step card vs CPU: max abs error "
        f"{worst:.3g} (limit {LENET_TOL}); 1.x net {net_1x_err:.3g}")
    return launches


def _s2s_program():
    """tests/torch_seq2seq_program.py, the JAX-free program the parity
    tests hold against paddle_tpu."""
    tests = str(Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_seq2seq_program as S
    return S


class _SyncCount:
    """Host syncs inside the block, by line (set_sync_debug_mode("warn"))."""

    def __enter__(self):
        self._catch = warnings.catch_warnings(record=True)
        self.caught = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        self._catch.__exit__(*exc)

    def sites(self):
        return _sync_sites(self.caught)


def _s2s_lstm_hold(lstm, x):
    """The encoder's LSTM (cuDNN) against its plain per-step loop on the
    same input, in train mode under one rng_scope seed (the same dropout
    masks between the layers): y, h, c, and the gradients of the input
    and every weight for the same cotangents; each path's ms (forward and
    backward, CUDA events, after one warm-up)."""
    g = torch.Generator(device=x.device).manual_seed(5)
    leaf = x.detach().requires_grad_()
    params = list(lstm.parameters())
    runs, ms = {}, {}
    for name, fn in (("cudnn", lstm.forward), ("loop", lstm.plain_forward)):
        def run():
            with pF.rng_scope(11):
                outs = fn(leaf)
            cts = [torch.randn(o.shape, generator=g.manual_seed(5 + i),
                               device=x.device) for i, o in enumerate(outs)]
            return outs, torch.autograd.grad(outs, [leaf] + params, cts)
        run()
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        runs[name] = run()
        e1.record()
        torch.cuda.synchronize()
        ms[name] = e0.elapsed_time(e1)
    worst = {}
    for k, (a, b) in enumerate(zip(runs["cudnn"][0], runs["loop"][0])):
        ok, err = close(a, b, **S2S_LSTM_TOL)
        worst["yhc"[k]] = err
        if not ok:
            raise AssertionError(f"cuDNN LSTM output {'yhc'[k]}: max abs "
                                 f"error {err}")
    names = ["x"] + [n for n, _ in lstm.named_parameters()]
    for n, a, b in zip(names, runs["cudnn"][1], runs["loop"][1]):
        err = float((a - b).abs().max())
        worst[f"d{n}"] = err
        if err > S2S_LSTM_GRAD * float(b.abs().max()) + 1e-6:
            raise AssertionError(f"cuDNN LSTM gradient {n}: max abs error "
                                 f"{err} (largest {float(b.abs().max())})")
    log(f"cuDNN LSTM vs plain loop at {tuple(x.shape)}: max abs errors "
        f"{worst}; fwd+bwd ms: cuDNN {ms['cudnn']:.3f}, loop "
        f"{ms['loop']:.3f}")
    return dict(max_abs_err=worst, ms=ms)


def _s2s_decode(S, net, src, sl):
    """The beam-10 decode timed (CUDA events, host clock, syncs by line),
    then its two holds: beam 1 against the greedy loop, and each beam's
    score against teacher forcing.  Returns (summary, launches)."""
    S.beam_search(paddle, net, src, sl, S2S_BEAM, 2)  # warm-up
    torch.cuda.synchronize()
    for c in COUNTERS.values():
        c.reset()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    # -- the main path: counters at 0 before, read right after ----------------
    with _SyncCount() as syncs:
        t0 = time.perf_counter()
        e0.record()
        out = S.beam_search(paddle, net, src, sl, S2S_BEAM, S2S_MAX_LEN)
        e1.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    launches = {n: c.value for n, c in COUNTERS.items()}
    # ---------------------------------------------------------------------------
    _expect_launches(launches, 0, (), "the seq2seq beam decode")
    ids, parents, scores = (S.host(out[k]) for k in
                            ("predicted_ids", "parent_ids", "scores"))
    steps = ids.shape[1]
    b = ids.shape[0]
    if ids.shape != (b, steps, S2S_BEAM) or not np.isfinite(scores).all():
        raise AssertionError(f"beam output {ids.shape}, finite scores "
                             f"{np.isfinite(scores).all()}")
    dec_ms = e0.elapsed_time(e1)
    sites = syncs.sites()
    summary = dict(steps=steps, decode_ms=dec_ms, host_ms=host_ms,
                   ms_a_step=dec_ms / steps,
                   beam_tokens_per_s=b * S2S_BEAM * steps / (dec_ms / 1e3),
                   source_tokens_per_s=b * steps / (dec_ms / 1e3),
                   syncs_per_step=sum(sites.values()) / steps,
                   sync_sites=sites)
    log(f"beam {S2S_BEAM} decode of {b} sources: {steps} steps in "
        f"{dec_ms:.1f} ms (CUDA events; host clock {host_ms:.1f} ms), "
        f"{dec_ms / steps:.3f} ms a step, {summary['beam_tokens_per_s']:.0f} "
        f"beam tokens/s, syncs a step {summary['syncs_per_step']:.2f} at "
        f"{sites}")
    greedy = S.greedy(paddle, net, src, sl, S2S_MAX_LEN)
    one = S.host(S.beam_search(paddle, net, src, sl, 1,
                               S2S_MAX_LEN)["predicted_ids"])[:, :, 0]
    if not np.array_equal(one, greedy):
        raise AssertionError(f"beam 1 differs from greedy at "
                             f"{int((one != greedy).sum())} tokens")
    seqs = S.backtrack(ids, parents)
    forced = S.sequence_scores(paddle, net, src, sl, seqs)
    last = torch.from_numpy(scores[:, -1, :])
    ok, err = close(torch.from_numpy(forced), last, **S2S_SCORE_TOL)
    if not ok:
        raise AssertionError(f"teacher-forced scores off by {err}")
    summary.update(greedy_equals_beam1=True, teacher_forced_max_abs_err=err,
                   finished_beams=int((seqs == S.EOS).any(-1).sum()),
                   best_scores=[float(v) for v in scores[:4, -1, 0]])
    log(f"beam 1 = greedy over {greedy.shape} tokens; teacher-forced "
        f"scores of the {seqs.shape[0] * seqs.shape[1]} beams within "
        f"{err:.3g} (limit {S2S_SCORE_TOL})")
    return summary, launches


@phase("seq2seq")
def seq2seq():
    """Paddle 2.x's seq2seq with attention at IWSLT'15's sizes through
    the port's 2.x API: Model.fit on one staged batch, the encoder's
    cuDNN LSTM against its loop, then beam and greedy decoding.
    Returns {"seq2seq_train": launches, "seq2seq_decode": launches}."""
    S = _s2s_program()
    cfg = S.IWSLT15
    torch.cuda.empty_cache()
    torch.manual_seed(0)
    t0 = time.perf_counter()
    with unique_name.guard():
        net = S.build(paddle, cfg, seed=0).to("cuda")
    batch = tuple(torch.from_numpy(a).cuda() for a in S.batch(cfg, seed=0))
    n_params = sum(p.numel() for p in net.parameters())
    log(f"seq2seq: {n_params / 1e6:.2f} M parameters, built in "
        f"{time.perf_counter() - t0:.1f} s; batch B={cfg['batch']}, "
        f"T={cfg['steps']}, target tokens unmasked "
        f"{int(batch[3].sum())}")
    model = S.prepare(paddle, net, cfg)
    clock = _StepClock().watch(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in COUNTERS.values():
        c.reset()
    # -- the main path: counters at 0 before, read right after ----------------
    model.fit([batch] * S2S_STEPS, epochs=1, verbose=0, callbacks=[clock])
    torch.cuda.synchronize()
    launches = {n: c.value for n, c in COUNTERS.items()}
    # ---------------------------------------------------------------------------
    mem = torch.cuda.max_memory_allocated()
    _expect_launches(launches, 0, (), f"{S2S_STEPS} seq2seq Model.fit steps")
    losses = clock.losses
    if len(losses) != S2S_STEPS or not np.isfinite(losses).all() \
            or not losses[-1] < S2S_FALL * losses[0]:
        raise AssertionError(f"seq2seq losses {losses}")
    timed = S2S_STEPS - 1
    step_ms = clock.events[0].elapsed_time(clock.events[-1]) / timed
    host_ms = (clock.host[-1] - clock.host[0]) * 1e3 / timed
    sites = clock.sync_sites()
    tokens = 2 * cfg["batch"] * cfg["steps"]  # source and target
    ins, labs = list(batch[:-1]), [batch[-1]]
    busy, wall, top = _profile(lambda: model.train_batch(ins, labs), top=8)
    summary = dict(
        steps=S2S_STEPS, step_ms=step_ms, host_step_ms=host_ms,
        tokens_per_s=tokens / (step_ms / 1e3),
        max_memory_allocated_bytes=mem, losses=losses,
        syncs_per_step=sum(sites.values()) / timed, sync_sites=sites,
        profiled_busy_ms=busy, profiled_wall_ms=wall,
        profiled_idle=max(0.0, 1 - busy / wall),
        top_kernels=[dict(name=k[:90], ms=ms, count=n) for k, ms, n in top])
    log(f"losses: {' '.join(f'{v:.3f}' for v in losses)}")
    log(f"seq2seq Model.fit B={cfg['batch']} T={cfg['steps']} f32: "
        f"{step_ms:.3f} ms a step over steps 2-{S2S_STEPS} (CUDA events; "
        f"host clock {host_ms:.3f} ms), {summary['tokens_per_s']:.0f} "
        f"source+target tokens/s, max_memory_allocated "
        f"{mem / 2 ** 30:.2f} GiB, host syncs a step "
        f"{summary['syncs_per_step']:.2f} at {sites}")
    net.train()
    with torch.no_grad():
        emb = net.encoder.embedder(batch[0])
    summary["lstm_hold"] = _s2s_lstm_hold(net.encoder.lstm, emb)
    del model, clock
    torch.cuda.empty_cache()
    decode, decode_launches = _s2s_decode(S, net, batch[0], batch[1])
    summary["decode"] = decode
    summary["card"] = card_line()
    log("seq2seq summary: " + json.dumps(summary))
    return {"seq2seq_train": launches, "seq2seq_decode": decode_launches}


def _s2s_static_program():
    """tests/torch_seq2seq_static_program.py, the JAX-free 1.x decode
    program the parity tests hold against paddle_tpu's Executor."""
    _s2s_program()
    import torch_seq2seq_static_program as SP
    return SP


def _static_run(exe, main, src, fetch, scope):
    """One run of a decode program: (fetches as LazyFetch, CUDA-event ms,
    host ms, {stat: delta} of the Executor's op count and host reads,
    syncs by line)."""
    stats0 = profiler.get_int_stats()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    with _SyncCount() as syncs:
        t0 = time.perf_counter()
        e0.record()
        out = exe.run(main, feed={"src": src}, fetch_list=fetch, scope=scope,
                      return_numpy=False)
        e1.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    stats = profiler.get_int_stats()
    delta = {k: stats.get(k, 0) - stats0.get(k, 0) for k in (
        "executor_op_count", "control_flow_host_reads")}
    return out, e0.elapsed_time(e1), host_ms, delta, syncs.sites()


def _eager_beam_ms(S, net, src, sl):
    """The 2.x beam decode (the seq2seq phase's) timed by CUDA events:
    (ms, steps)."""
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    e0.record()
    out = S.beam_search(paddle, net, src, sl, S2S_BEAM, S2S_MAX_LEN)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1), int(out["predicted_ids"].shape[1])


def _static_cut_check(fluid, S, SP, net, cfg, src):
    """The greedy and beam programs at STATIC_CUT sources on the card
    against the same programs on the CPU Executor from the same weights:
    the ids equal, the beam scores within S2S_SCORE_TOL."""
    cpu_state = {k: v.detach().cpu() for k, v in net.state_dict().items()}
    got = {}
    for beam in (0, S2S_BEAM):
        with unique_name.guard():
            main, _, fetch = SP.build(fluid, cfg, STATIC_CUT, src.shape[1],
                                      beam_size=beam)
        runs = []
        for dev, state in (("cuda", None), ("cpu", cpu_state)):
            scope = fluid.Scope()
            if state is None:
                SP.load_from_2x(scope, net, cfg)
                exe = fluid.Executor()
            else:
                for n, v in SP.program_weights(state, cfg).items():
                    scope.set(n, v.contiguous())
                exe = fluid.Executor(fluid.CPUPlace())
            runs.append(exe.run(main, feed={"src": src[:STATIC_CUT].cpu()
                                            .numpy()},
                                fetch_list=fetch, scope=scope))
        card_out, cpu_out = runs
        if not np.array_equal(card_out[0], cpu_out[0]):
            raise AssertionError(
                f"beam {beam} at B={STATIC_CUT}: the card's ids differ from "
                f"the CPU's at {int((card_out[0] != cpu_out[0]).sum())} of "
                f"{card_out[0].size}")
        got[f"beam_{beam}_steps"] = int(card_out[0].shape[1])
        if beam:
            ok, err = close(torch.from_numpy(card_out[1]),
                            torch.from_numpy(cpu_out[1]), **S2S_SCORE_TOL)
            if not ok:
                raise AssertionError(f"beam scores card vs CPU: {err}")
            got["beam_score_max_abs_err"] = err
    log(f"static decode at B={STATIC_CUT}, card vs CPU Executor: greedy and "
        f"beam {S2S_BEAM} ids equal, {got}")
    return got


@phase("static_decode")
def static_decode():
    """The seq2seq model's inference half as a 1.x static program
    (tests/torch_seq2seq_static_program.py: embedding + dynamic_lstm, the
    decoder cell written out, a While block over capacity-S2S_MAX_LEN
    tensor arrays) through fluid.Executor on the card at IWSLT'15's
    widths, B=128: greedy, held token for token against the 2.x greedy
    loop over the same weights, and beam 10, each beam's score held
    against teacher forcing (S2S_SCORE_TOL); decode ms a step beside the
    2.x beam decode's, timed in turns; host reads and syncs a step, host
    us an op, a profiled decode's idle share; then STATIC_CUT sources on
    the card against the CPU Executor.  Returns the launches of the two
    decodes."""
    from paddle_tpu_torch import fluid

    S, SP = _s2s_program(), _s2s_static_program()
    cfg = S.IWSLT15
    torch.cuda.empty_cache()
    with unique_name.guard():
        net = S.build(paddle, cfg, seed=0).to("cuda")
    net.eval()
    src, sl = (torch.from_numpy(a).cuda() for a in S.batch(cfg, seed=0)[:2])
    b = src.shape[0]
    summary, launches, fetched = {}, {}, {}
    for beam in (0, S2S_BEAM):
        what = "greedy" if not beam else f"beam_{beam}"
        t0 = time.perf_counter()
        with unique_name.guard():
            main, _, fetch = SP.build(fluid, cfg, b, src.shape[1],
                                      beam_size=beam)
        scope, exe = fluid.Scope(), fluid.Executor()
        SP.load_from_2x(scope, net, cfg)
        build_s = time.perf_counter() - t0
        exe.run(main, feed={"src": src}, fetch_list=fetch, scope=scope)
        for c in COUNTERS.values():
            c.reset()
        # -- the main path: counters at 0 before, read right after ------------
        out, ms, host_ms, delta, sites = _static_run(exe, main, src, fetch,
                                                     scope)
        launches[f"static_{what}"] = {n: c.value for n, c in
                                      COUNTERS.items()}
        # -----------------------------------------------------------------------
        _expect_launches(launches[f"static_{what}"], 0, (),
                         f"the static {what} decode")
        fetched[beam] = [o.numpy() for o in out]
        steps = fetched[beam][0].shape[1]
        ops = delta["executor_op_count"]
        summary[what] = dict(
            steps=steps, decode_ms=ms, host_ms=host_ms, ms_a_step=ms / steps,
            host_reads=delta["control_flow_host_reads"],
            host_reads_per_step=delta["control_flow_host_reads"] / steps,
            syncs_per_step=sum(sites.values()) / steps, sync_sites=sites,
            ops=ops, ops_per_step=ops / steps,
            host_us_per_op=1e3 * host_ms / ops, build_s=build_s,
            block_ops=[len(blk.ops) for blk in main.blocks])
        log(f"static {what} decode of {b} sources: {steps} steps in "
            f"{ms:.1f} ms (CUDA events; host clock {host_ms:.1f} ms), "
            f"{ms / steps:.3f} ms a step, {ops} ops run "
            f"({ops / steps:.1f} a step, {1e3 * host_ms / ops:.1f} host us "
            f"an op), host reads {summary[what]['host_reads']} "
            f"({summary[what]['host_reads_per_step']:.2f} a step), syncs by "
            f"line {sites}")
        if beam:
            busy, wall, top = _profile(lambda: exe.run(
                main, feed={"src": src}, fetch_list=fetch, scope=scope,
                return_numpy=False), top=8)
            summary[what].update(
                profiled_busy_ms=busy, profiled_wall_ms=wall,
                profiled_idle=max(0.0, 1 - busy / wall),
                top_kernels=[dict(name=k[:90], ms=t, count=n)
                             for k, t, n in top])
            turns = []
            for order in ("eager", "static", "static", "eager"):
                if order == "eager":
                    t, n = _eager_beam_ms(S, net, src, sl)
                else:
                    _, t, _, _, _ = _static_run(exe, main, src, fetch, scope)
                    n = steps
                turns.append((order, t / n))
            summary["beam_turns_ms_a_step"] = turns
            log(f"beam {S2S_BEAM} ms a step in turns (2.x dynamic_decode / "
                f"static While): {turns}")
        del exe, scope
    # greedy: token for token against the 2.x greedy loop
    eager = S.greedy(paddle, net, src, sl, S2S_MAX_LEN)
    static_ids = fetched[0][0]
    if static_ids.shape != eager.shape or not np.array_equal(static_ids,
                                                             eager):
        diff = (static_ids != eager).sum() if static_ids.shape == \
            eager.shape else "shape"
        raise AssertionError(f"static greedy {static_ids.shape} vs 2.x "
                             f"greedy {eager.shape}: {diff} tokens differ")
    # beam: every beam's score against teacher forcing
    seqs, scores = SP.sentence_scores(fetched[S2S_BEAM][0],
                                      fetched[S2S_BEAM][1], S2S_BEAM)
    if not np.isfinite(scores).all() or not (
            np.diff(scores, axis=1) <= 0).all():
        raise AssertionError("beam scores not finite or not best first")
    forced = S.sequence_scores(paddle, net, src, sl, seqs)
    ok, err = close(torch.from_numpy(scores), torch.from_numpy(forced),
                    **S2S_SCORE_TOL)
    if not ok:
        raise AssertionError(f"static beam scores vs teacher forcing: {err}")
    summary.update(greedy_equals_2x=True, greedy_tokens=int(eager.size),
                   teacher_forced_max_abs_err=err,
                   finished_beams=int((seqs == S.EOS).any(-1).sum()),
                   best_scores=[float(v) for v in scores[:4, 0]])
    log(f"static greedy = 2.x greedy over {eager.shape} tokens; beam "
        f"{S2S_BEAM}: the {seqs.shape[0] * seqs.shape[1]} beams' scores "
        f"within {err:.3g} of teacher forcing (limit {S2S_SCORE_TOL})")
    summary["cut"] = _static_cut_check(fluid, S, SP, net, cfg, src)
    summary["card"] = card_line()
    log("static_decode summary: " + json.dumps(summary))
    return launches


def _book_modules():
    """tests/torch_srl_program.py and tests/torch_book_programs.py, the
    JAX-free programs the parity tests hold against paddle_tpu."""
    tests = str(Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_book_programs as B
    import torch_srl_program as S
    return S, B


def _card_vs_cpu(fluid, main, startup, feed, fetches, steps, what,
                 decode=None):
    """The card's Executor against the CPU's on one program, from the
    same startup values, `steps` steps each from the CPU's state: the
    loss (fetches[0]) within SRL_LOSS_RTOL, every float state var within
    SRL_STATE_TOL; with `decode` (an inference program and its fetch),
    the paths equal where `feed["length"]` says the rows live."""
    from paddle_tpu_torch.convert import load_jax_scope

    gpu, cpu = fluid.Executor(), fluid.Executor(fluid.CPUPlace())
    gs, cs = fluid.Scope(), fluid.Scope()
    gpu.run(startup, scope=gs)
    cpu.run(startup, scope=cs)
    load_jax_scope(cs, {n: gs.get(n).cpu().numpy()
                        for n in gs.local_var_names()})
    losses, worst_state = [], {}
    for i in range(steps):
        load_jax_scope(gs, {n: cs.get(n).numpy()
                            for n in cs.local_var_names()})
        g = float(gpu.run(main, feed=feed, fetch_list=fetches[:1],
                          scope=gs)[0])
        c = float(cpu.run(main, feed=feed, fetch_list=fetches[:1],
                          scope=cs)[0])
        losses.append((g, c))
        if not (np.isfinite(g) and abs(g - c) <= SRL_LOSS_RTOL * abs(c)):
            raise AssertionError(f"{what} step {i}: card loss {g} vs CPU {c}")
        for n, e in _fluid_state_errors(gs, cs).items():
            worst_state[n] = max(worst_state.get(n, 0.0), e)
    name, err = max(worst_state.items(), key=lambda kv: kv[1])
    if err > SRL_STATE_TOL:
        raise AssertionError(f"{what}: {name} relative L2 {err}")
    out = dict(losses=losses, worst_state=name, worst_state_rel_l2=err)
    if decode is not None:
        prog, var = decode
        load_jax_scope(gs, {n: cs.get(n).numpy()
                            for n in cs.local_var_names()})
        g = gpu.run(prog, feed=feed, fetch_list=[var], scope=gs)[0]
        c = cpu.run(prog, feed=feed, fetch_list=[var], scope=cs)[0]
        live = np.arange(g.shape[1])[None, :] < feed["length"][:, None]
        if not np.array_equal(g[live], c[live]) or (g[~live] != 0).any():
            raise AssertionError(f"{what}: decoded paths differ at "
                                 f"{int((g != c)[live].sum())} positions")
        out["decoded_positions_equal"] = int(live.sum())
    log(f"{what} card vs CPU Executor, {steps} steps from the same state: "
        f"losses {[(round(a, 6), round(b, 6)) for a, b in losses]}, worst "
        f"state var {name} {err:.3g} (limits {SRL_LOSS_RTOL}, "
        f"{SRL_STATE_TOL})" + (f", decoded paths equal on "
                               f"{out['decoded_positions_equal']} live "
                               f"positions" if decode else ""))
    return out


def _srl_arm_hold():
    """The lstm rule's two arms on the card at the book SRL test's
    default activations: one torch.lstm (cuDNN) against the loop, y and
    the cell, and the gradients of the input, the weight and the bias
    for the same cotangents; each arm's ms forward and backward (CUDA
    events, after a warm-up)."""
    from paddle_tpu_torch.ops import registry as R
    from paddle_tpu_torch.ops import rnn_ops

    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(10, 64, 512, generator=g, device="cuda")
    w = torch.randn(128, 512, generator=g, device="cuda") * 0.1
    b = torch.randn(1, 512, generator=g, device="cuda") * 0.1
    cts = [torch.randn(10, 64, 128, generator=g, device="cuda")
           for _ in range(2)]
    op = type("Op", (), {"attr": lambda self, k, d=None: d})()
    runs, ms = {}, {}
    for arm in ("cudnn", "loop"):
        rnn_ops.LSTM_CUDNN[0] = arm == "cudnn"
        try:
            def run():
                leaves = [t.detach().requires_grad_() for t in (x, w, b)]
                with torch.enable_grad():
                    out = rnn_ops._lstm(R.LowerCtx(device="cuda"), op, {
                        "Input": [leaves[0]], "Weight": [leaves[1]],
                        "Bias": [leaves[2]]})
                    outs = [out["Hidden"][0], out["Cell"][0]]
                    grads = torch.autograd.grad(outs, leaves, cts)
                return [t.detach() for t in outs + list(grads)]
            before = dict(rnn_ops.LSTM_ARMS)
            run()
            if rnn_ops.LSTM_ARMS[arm] != before[arm] + 1:
                raise AssertionError(f"the lstm rule took no {arm} arm")
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            runs[arm] = run()
            e1.record()
            torch.cuda.synchronize()
            ms[arm] = e0.elapsed_time(e1)
        finally:
            rnn_ops.LSTM_CUDNN[0] = True
    worst = {}
    for k, name in enumerate(("hidden", "cell", "dx", "dw", "db")):
        a, ref = runs["cudnn"][k], runs["loop"][k]
        if k < 2:
            ok, err = close(a, ref, **SRL_ARM_TOL)
        else:
            err = float((a - ref).abs().max())
            ok = err <= S2S_LSTM_GRAD * float(ref.abs().max()) + 1e-6
        worst[name] = err
        if not ok:
            raise AssertionError(f"lstm arms differ in {name}: {err}")
    log(f"lstm rule arms at (10, 64, 512), default activations: max abs "
        f"errors {worst}; fwd+bwd ms: cuDNN {ms['cudnn']:.3f}, loop "
        f"{ms['loop']:.3f}")
    return dict(max_abs_err=worst, ms=ms)


@phase("srl")
def srl():
    """The book's semantic-role-labelling program (db_lstm: depth 8, 512
    wide, CoNLL-05's vocabularies) through fluid.Executor on the card:
    the startup program, SRL_STEPS SGD steps on one staged batch (steps
    2 on timed by CUDA events, with the host clock and the host syncs by
    line), one profiled step, then crf_decoding.  Then the small program
    and the three other book programs against the CPU Executor, and the
    lstm rule's two arms.  Returns the launches of the main path."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.ops import rnn_ops

    S, B = _book_modules()
    cfg = S.BOOK
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with unique_name.guard():
        main, startup, f = S.build(fluid, cfg)
    infer = main.clone(for_test=True)
    n_ops = len(main.global_block().ops)
    params = [p for p in main.all_parameters() if p.trainable]
    n_params = sum(int(np.prod(p.shape)) for p in params)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    host_feed = S.batch(cfg, seed=0)
    feed = {k: torch.from_numpy(v).cuda() for k, v in host_feed.items()}
    live = S.live_tokens(host_feed)
    log(f"srl: {n_params / 1e6:.2f} M trainable parameters, {n_ops} ops a "
        f"step, built and initialised in {time.perf_counter() - t0:.1f} s; "
        f"B={cfg['batch']}, T={cfg['t']}, {live} live tokens")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in COUNTERS.values():
        c.reset()
    arms0 = dict(rnn_ops.LSTM_ARMS)
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(SRL_STEPS)]
    host, fetched = [], []
    # -- the main path: counters at 0 before, read right after ----------------
    with _SyncCount() as syncs:
        for i in range(SRL_STEPS):
            if i == 1:
                syncs.caught.clear()
            fetched.append(exe.run(main, feed=feed, fetch_list=[
                f["loss"], f["lr"]], scope=scope, return_numpy=False))
            events[i].record()
            host.append(time.perf_counter())
        torch.cuda.synchronize()
    launches = {n: c.value for n, c in COUNTERS.items()}
    # ---------------------------------------------------------------------------
    arms = {k: rnn_ops.LSTM_ARMS[k] - arms0[k] for k in arms0}
    mem = torch.cuda.max_memory_allocated()
    _expect_launches(launches, 0, (), f"{SRL_STEPS} srl steps")
    if arms != {"loop": cfg["depth"] * SRL_STEPS, "cudnn": 0}:
        raise AssertionError(f"lstm arms taken {arms}")
    losses = [float(o[0]) for o in fetched]
    lrs = [float(o[1]) for o in fetched]
    if not np.isfinite(losses).all() or not losses[-1] < losses[0] \
            or lrs != [float(np.float32(cfg["lr"]))] * SRL_STEPS:
        raise AssertionError(f"srl losses {losses}, learning rates {lrs}")
    timed = SRL_STEPS - 1
    step_ms = events[0].elapsed_time(events[-1]) / timed
    host_ms = (host[-1] - host[0]) * 1e3 / timed
    sites = syncs.sites()
    busy, wall, top = _profile(lambda: exe.run(
        main, feed=feed, fetch_list=[f["loss"]], scope=scope,
        return_numpy=False), top=8)
    # decoding: a warm-up, then one timed
    exe.run(infer, feed=feed, fetch_list=[f["decode"]], scope=scope,
            return_numpy=False)
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    path = exe.run(infer, feed=feed, fetch_list=[f["decode"]], scope=scope,
                   return_numpy=False)[0]
    e1.record()
    torch.cuda.synchronize()
    decode_ms = e0.elapsed_time(e1)
    path = path.numpy()
    live_mask = np.arange(cfg["t"])[None, :] < host_feed["length"][:, None]
    if path.shape != (cfg["batch"], cfg["t"]) or (path[~live_mask] != 0).any() \
            or path.min() < 0 or path.max() >= cfg["label_dict"]:
        raise AssertionError(f"crf_decoding path {path.shape}, range "
                             f"[{path.min()}, {path.max()}]")
    acc = float((path == host_feed["target"])[live_mask].mean())
    summary = dict(
        steps=SRL_STEPS, step_ms=step_ms, host_step_ms=host_ms,
        live_tokens_per_s=live / (step_ms / 1e3),
        profiled_busy_ms=busy, profiled_wall_ms=wall,
        profiled_idle=max(0.0, 1 - busy / wall),
        syncs_per_step=sum(sites.values()) / timed, sync_sites=sites,
        ops_per_step=n_ops, host_us_per_op=1e3 * host_ms / n_ops,
        max_memory_allocated_bytes=mem, lstm_arm="loop",
        lstm_arms=arms, loss_first=losses[0], loss_last=losses[-1],
        losses=losses, decode_ms=decode_ms, decode_accuracy=acc,
        top_kernels=[dict(name=k[:90], ms=ms, count=n) for k, ms, n in top])
    log(f"losses: {' '.join(f'{v:.3f}' for v in losses)}")
    log(f"srl db_lstm B={cfg['batch']} T={cfg['t']} f32 through "
        f"fluid.Executor: {step_ms:.3f} ms a step over steps 2-{SRL_STEPS} "
        f"(CUDA events; host clock {host_ms:.3f} ms), "
        f"{summary['live_tokens_per_s']:.0f} live tokens/s, idle "
        f"{100 * summary['profiled_idle']:.1f}% of a profiled step, host "
        f"syncs a step {summary['syncs_per_step']:.2f} at {sites}, "
        f"{n_ops} ops a step at {summary['host_us_per_op']:.1f} host us an "
        f"op, max_memory_allocated {mem / 2 ** 20:.1f} MiB, lstm arm "
        f"{arms}, loss {losses[0]:.3f} at step 1 and {losses[-1]:.3f} at "
        f"step {SRL_STEPS}; crf_decoding {decode_ms:.3f} ms (CUDA events), "
        f"{100 * acc:.1f}% of the live labels")
    del exe, scope
    torch.cuda.empty_cache()
    small = S.SMALL
    with unique_name.guard():
        sm, ss, sf = S.build(fluid, small)
    summary["small"] = _card_vs_cpu(
        fluid, sm, ss, S.batch(small, seed=0), [sf["loss"]], 3,
        "db_lstm depth 2, 32 wide",
        decode=(sm.clone(for_test=True), sf["decode"]))
    summary["book"] = {}
    for name in ("word2vec_ngram", "recommender_towers", "sentiment_conv"):
        bm, bs, bf = B.build(fluid, name)
        summary["book"][name] = _card_vs_cpu(fluid, bm, bs, B.feeds(name),
                                             bf, BOOK_STEPS, f"book {name}")
    summary["lstm_arms_hold"] = _srl_arm_hold()
    summary["card"] = card_line()
    log("srl summary: " + json.dumps(summary))
    return {"srl": launches}

# -- MobileNetV2 and VGG16 (phase 19) -------------------------------------------
# paddle_tpu/vision/models.py's mobilenet_v2() (scale 1.0, 1000 classes;
# Dropout 0.2 live) and vgg16() (Dropout 0.5 twice) at the resnet
# phase's configuration: B=128, 224^2, bf16 over fp32 masters, momentum
# 0.9, lr 0.1, one batch from RandomState(0).  1 warm-up and MOBILE_TIMED
# steps timed; the loss falls: the mean of the last MOBILE_TAIL losses
# under the first (the fixed batch is learned while the dropout masks
# change every step)
MOBILE_BATCH, MOBILE_HW, MOBILE_CLASSES = 128, 224, 1000
MOBILE_TIMED, MOBILE_TAIL = 30, 5
MOBILE_LR, MOBILE_MOMENTUM = 0.1, 0.9
# VGG16 (no batch norm) from its Xavier start (a first loss of 20.94)
# diverges at 0.1 (1.2e6, then NaN at step 3 on the H100) and at 0.01
# its losses spike as the dropout masks change, to NaN at step 28 in one
# run of five; at 0.001 the one batch is learned steadily (PERF.md)
VGG_LR = 0.001
# the f32 card-vs-CPU holds: mobilenet_v2(scale=0.25) and
# vgg11(batch_norm=True), 10 classes, B=4 of 64 x 64, dropout off; the
# resnet phase's RESNET_TOL for logits, loss and running statistics;
# gradients in relative L2 within MOBILE_KINK: a ReLU6 kink flip moves a
# whole term, and the BN weights in front of the first ReLU6s have small
# gradients that are sums of cancelling terms (3.2 % between two f32
# summation orders on the CPU alone; tests/test_torch_vision_models.py)
MOBILE_HOLD_BATCH, MOBILE_HOLD_HW = 4, 64
MOBILE_KINK = 5e-2
# a gradient that is 0 in exact arithmetic (under 1e-10 in float64 on
# the CPU) is f32 rounding noise, up to 1.5e-5 on the CPU: held under
# ZERO_GRAD on the card
ZERO_GRAD = 1e-4
# PaddleGAN's CycleGAN (phase 20, tests/torch_cyclegan_program.
# HORSE2ZEBRA: ngf 64, 9 blocks, ndf 64, 3 layers, B=1, 256^2, f32 with
# TF32 off): 1 warm-up and CG_TIMED steps on one seeded pair; the cycle
# loss (A + B) falls from step 1 to the last
CG_TIMED = 10
# the cut generator (ngf 64, 2 blocks, 64 x 64) on the card against the
# CPU, f32: output within CG_TOL, every gradient within RESNET_KINK in
# relative L2; the output_padding form against the crop form on the
# card within CG_TOL (two algorithms of the same transposed convolution)
CG_HOLD_BLOCKS, CG_HOLD_HW = 2, 64
CG_TOL = dict(atol=1e-4, rtol=1e-4)
# the gradient of a bias in front of an instance norm (exactly 0): f32
# rounding of a sum over the 64 x 64 map of dL/dy terms of about 1e-4
CG_BIAS_NOISE = 1e-5


def conv_net_fwd_flops(model, batch, hw):
    """The forward's FLOPs from the layer shapes: 2 x the MACs of every
    Conv2D (output elements x in_channels / groups x kh x kw) and Linear
    (rows x in x out), read by hooks on one B=1 forward, times `batch`.
    Norms, activations and pools are left out (under 1 % of either
    model)."""
    macs = [0]

    def conv_hook(mod, inp, out):
        kh, kw = mod.weight.shape[2:]
        macs[0] += out.numel() * mod.weight.shape[1] * kh * kw

    def linear_hook(mod, inp, out):
        macs[0] += out.numel() * mod.weight.shape[0]

    hooks = [m.register_forward_hook(conv_hook) for m in model.modules()
             if isinstance(m, pnn.Conv2D)]
    hooks += [m.register_forward_hook(linear_hook) for m in model.modules()
              if isinstance(m, pnn.Linear)]
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            dev = next(iter(model.parameters())).device
            model(torch.zeros(1, 3, hw, hw, device=dev))
    finally:
        for h in hooks:
            h.remove()
        model.train(was)
    return 2.0 * macs[0] * batch


def _conv_share(fn, depthwise):
    """fn() once under torch.profiler with shapes: the device time of the
    convolutions (forward and backward) whose weight is (C, 1, k, k)
    with C = groups, i.e. the depthwise ones, and of all convolutions."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    dw = total = 0.0
    for e in prof.events():
        if e.name not in ("aten::convolution", "aten::convolution_backward"):
            continue
        ms = getattr(e, "device_time_total", 0.0) / 1e3
        shapes = e.input_shapes or []
        w = shapes[1] if e.name == "aten::convolution" else \
            (shapes[2] if len(shapes) > 2 else None)
        total += ms
        if w and len(w) == 4 and w[1] == 1 and w[0] in depthwise:
            dw += ms
    return dw, total


def _mobile_train(name, model, flops, lr):
    """The resnet phase's step on `model` at `lr`: 1 warm-up,
    MOBILE_TIMED timed steps (CUDA events; host syncs counted), one
    profiled.  Returns (launches, summary)."""
    step, state = VT.build_train_step(model, lr=lr,
                                      momentum=MOBILE_MOMENTUM, bf16=True)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(MOBILE_BATCH, 3, MOBILE_HW, MOBILE_HW)
                         .astype("float32")).cuda()
    y = torch.from_numpy(rng.randint(0, MOBILE_CLASSES, MOBILE_BATCH)
                         .astype("int64")).cuda()
    buffers = [k for k, _ in model.named_buffers()]
    stats0 = {k: state["params"][k].clone() for k in buffers}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in COUNTERS.values():
        c.reset()
    # -- the main path: counters at 0 before, read right after ---------------
    losses = []
    t0 = time.perf_counter()
    state, loss = step(state, x, y)  # warm-up
    losses.append(loss)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with _SyncCount() as syncs:
        t0 = time.perf_counter()
        e0.record()
        for _ in range(MOBILE_TIMED):
            state, loss = step(state, x, y)
            losses.append(loss)
        e1.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / MOBILE_TIMED
    launches = {n: c.value for n, c in COUNTERS.items()}
    # --------------------------------------------------------------------------
    mem = torch.cuda.max_memory_allocated()
    step_ms = e0.elapsed_time(e1) / MOBILE_TIMED
    sites = syncs.sites()
    losses = [float(v) for v in losses]
    log(f"{name} losses: {' '.join(f'{v:.4f}' for v in losses)}")
    _expect_launches(launches, 0, (), f"{MOBILE_TIMED + 1} {name} steps")
    if not all(np.isfinite(losses)) or not \
            np.mean(losses[-MOBILE_TAIL:]) < losses[0]:
        raise AssertionError(f"{name} losses are not finite and falling")
    if not all(bool(torch.isfinite(v).all()) for v in state["vel"].values()):
        raise AssertionError(f"a {name} velocity is not finite")
    moved = sum(not torch.equal(state["params"][k], stats0[k])
                for k in buffers)
    if moved != len(buffers):
        raise AssertionError(f"{name}: only {moved} of {len(buffers)} "
                             f"running statistics moved")
    summary = dict(step_ms=step_ms, host_step_ms=host_ms,
                   images_per_s=MOBILE_BATCH / (step_ms / 1e3),
                   step_flops=flops,
                   mfu=flops / (step_ms / 1e3) / PEAK_BF16_FLOPS,
                   warmup_step_s=warm_s, max_memory_allocated_bytes=mem,
                   syncs_per_step=sum(sites.values()) / MOBILE_TIMED,
                   sync_sites=sites, losses=losses)
    log(f"{name} train step B={MOBILE_BATCH} {MOBILE_HW}^2 bf16: "
        f"{step_ms:.3f} ms (CUDA events; host clock {host_ms:.3f} ms), "
        f"{summary['images_per_s']:.1f} images/s, MFU "
        f"{100 * summary['mfu']:.2f}% of 989 TFLOP/s ({flops / 1e12:.4f} "
        f"TFLOP a step, 3 x conv_net_fwd_flops), warm-up step "
        f"{warm_s:.2f} s, max_memory_allocated {mem / 2 ** 30:.2f} GiB, "
        f"host syncs a step {summary['syncs_per_step']:.2f} at {sites}")
    busy, wall, top = _profile(lambda: step(state, x, y), top=10)
    depthwise = {m.weight.shape[0] for m in model.modules()
                 if isinstance(m, pnn.Conv2D) and m._groups > 1
                 and m._groups == m.weight.shape[0]}
    dw_ms, conv_ms = _conv_share(lambda: step(state, x, y), depthwise)
    summary.update(profiled_busy_ms=busy, profiled_wall_ms=wall,
                   profiled_idle=max(0.0, 1 - busy / wall),
                   conv_device_ms=conv_ms, depthwise_device_ms=dw_ms,
                   top_kernels=[dict(name=k[:90], ms=ms, count=n)
                                for k, ms, n in top])
    log(f"{name}: convolutions {conv_ms:.3f} ms of the step's device "
        f"time (forward and backward), of which depthwise {dw_ms:.3f} ms "
        f"({100 * dw_ms / max(busy, 1e-9):.1f}% of the busy "
        f"{busy:.3f} ms)")
    return launches, summary


def _mobile_step(make, dev, x, y, dtype=torch.float32):
    """One train forward and backward of make() (dropout off) on `dev` in
    `dtype`: logits, loss, gradients and running statistics, on the
    CPU."""
    model = make(dev).to(dtype).train()
    x = x.to(dtype)
    for m in model.modules():
        if isinstance(m, pnn.Dropout):
            m.p = 0.0
    xd = x.to(dev)
    if dev == "cuda":
        xd = xd.contiguous(memory_format=torch.channels_last)
    logits = model(xd)
    loss = -torch.log_softmax(logits, -1).gather(1, y.to(dev)[:, None]) \
        .mean()
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    return dict(logits=logits.detach().cpu(), loss=loss.detach().cpu(),
                grads={k: g.cpu() for k, g in zip(named, grads)},
                stats={k: b.cpu() for k, b in model.named_buffers()})


def _mobile_hold(name, make):
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(MOBILE_HOLD_BATCH, 3, MOBILE_HOLD_HW,
                                   MOBILE_HOLD_HW).astype("float32"))
    y = torch.from_numpy(rng.randint(0, 10, MOBILE_HOLD_BATCH)
                         .astype("int64"))
    gpu, cpu = _mobile_step(make, "cuda", x, y), _mobile_step(make, "cpu",
                                                             x, y)
    truth = _mobile_step(make, "cpu", x, y, torch.float64)
    worst = {}
    for key in ("logits", "loss"):
        ok, worst[key] = close(gpu[key], cpu[key], **RESNET_TOL)
        if not ok:
            raise AssertionError(f"{name} {key}: card vs CPU {worst[key]}")
    for k, b in cpu["stats"].items():
        ok, err = close(gpu["stats"][k], b, **RESNET_TOL)
        worst["stats"] = max(worst.get("stats", 0.0), err)
        if not ok:
            raise AssertionError(f"{name} running stat {k}: {err}")
    zeros = []
    for k, g in cpu["grads"].items():
        if float(truth["grads"][k].abs().max()) < 1e-10:
            # 0 in exact arithmetic (under 1e-10 in float64 on the CPU): a
            # BN bias whose output reaches the loss only through a linear
            # layer and another train-mode BN, which takes the channel's
            # mean off; f32 rounding noise on both devices, held by its
            # size
            zeros.append(k)
            worst["zero_grads"] = max(worst.get("zero_grads", 0.0),
                                      float(gpu["grads"][k].abs().max()))
            if not worst["zero_grads"] < ZERO_GRAD:
                raise AssertionError(f"{name} gradient {k}: "
                                     f"{worst['zero_grads']} on the card")
            continue
        rel = float((gpu["grads"][k] - g).norm() / g.norm())
        worst["grads_rel_l2"] = max(worst.get("grads_rel_l2", 0.0), rel)
        if not (rel <= MOBILE_KINK and torch.isfinite(gpu["grads"][k]).all()):
            raise AssertionError(f"{name} gradient {k}: relative L2 {rel}")
    log(f"{name} f32 train step, card vs CPU: max abs logits "
        f"{worst['logits']:.3g}, loss {worst['loss']:.3g}, running stats "
        f"{worst['stats']:.3g} (limit {RESNET_TOL}); gradients' worst "
        f"relative L2 {worst['grads_rel_l2']:.3g} (limit {MOBILE_KINK}); "
        f"{len(zeros)} gradients 0 in exact arithmetic, at most "
        f"{worst.get('zero_grads', 0.0):.3g} (limit {ZERO_GRAD})")
    return worst


@phase("mobilenet")
def mobilenet():
    """MobileNetV2 and VGG16 training at B=128, 224^2 through
    vision.train.build_train_step (bf16 over fp32 masters, momentum
    SGD lr 0.1, dropout live), cuDNN's algorithm search on; then
    mobilenet_v2(scale=0.25) and vgg11(batch_norm=True) in f32 on the
    card against the CPU.  Returns {"mobilenet": launches, "vgg16":
    launches}."""
    torch.backends.cudnn.benchmark = True
    out, summary = {}, {}
    for name, make, lr in (
            ("mobilenet_v2", lambda: VM.mobilenet_v2(
                num_classes=MOBILE_CLASSES), MOBILE_LR),
            ("vgg16", lambda: VM.vgg16(num_classes=MOBILE_CLASSES), VGG_LR)):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        model = make()
        n = sum(p.numel() for p in model.parameters())
        flops = 3 * conv_net_fwd_flops(model, MOBILE_BATCH, MOBILE_HW)
        log(f"{name}: {n / 1e6:.2f} M parameters, built in "
            f"{time.perf_counter() - t0:.1f} s; B={MOBILE_BATCH} "
            f"{MOBILE_HW}x{MOBILE_HW}, bf16 over fp32 masters, lr {lr}, "
            f"momentum {MOBILE_MOMENTUM}, dropout live")
        out["mobilenet" if name == "mobilenet_v2" else name], \
            summary[name] = _mobile_train(name, model, flops, lr)
        summary[name]["parameters"] = n
        del model
    torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = False
    summary["holds"] = {
        "mobilenet_v2_0.25": _mobile_hold(
            "mobilenet_v2(scale=0.25)", lambda dev: VM.mobilenet_v2(
                scale=0.25, num_classes=10, device=dev, seed=2)),
        "vgg11_bn": _mobile_hold(
            "vgg11(batch_norm=True)", lambda dev: VM.vgg11(
                batch_norm=True, num_classes=10, device=dev, seed=2))}
    summary["card"] = card_line()
    log("mobilenet summary: " + json.dumps(summary))
    return out


def _cg_program():
    """tests/torch_cyclegan_program.py, the JAX-free program the parity
    tests hold against paddle_tpu."""
    tests = str(Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_cyclegan_program as C
    return C


def _cg_hold(C):
    """The generator cut to CG_HOLD_BLOCKS blocks at ngf 64: an L1 loss
    of G(x) against y, forward and backward, on the card against the CPU
    (f32); then the output_padding form against the crop form on the
    card (the same weights: the same seed and state_dict order)."""
    cfg = dict(C.HORSE2ZEBRA, n_blocks=CG_HOLD_BLOCKS, size=CG_HOLD_HW)
    rng = np.random.RandomState(5)
    x, y = (torch.from_numpy(rng.uniform(-1, 1, (1, 3, CG_HOLD_HW,
                                                 CG_HOLD_HW))
                             .astype("float32")) for _ in range(2))
    res = {}
    for dev in ("cuda", "cpu"):
        paddle.set_device(dev)
        try:
            g = C.build(paddle, cfg, seed=7)["G_A"].to(dev)
            out = g(x.to(dev))
            loss = paddle.nn.L1Loss()(out, y.to(dev))
            named = dict(g.named_parameters())
            grads = torch.autograd.grad(loss, list(named.values()))
            res[dev] = dict(out=out.detach().cpu(), grads={
                k: v.cpu() for k, v in zip(named, grads)})
        finally:
            paddle.set_device("cuda")
    ok, err = close(res["cuda"]["out"], res["cpu"]["out"], **CG_TOL)
    if not ok:
        raise AssertionError(f"cyclegan generator: card vs CPU {err}")
    # a bias in front of an instance norm has an exact gradient of 0 (the
    # norm takes the channel's mean off): both devices give rounding
    # noise there, held by its size, not relatively
    g_cpu = C.build(paddle, cfg, seed=7)["G_A"]
    normed = {f"model.{i - 1}.bias" for i, m in enumerate(g_cpu.model)
              if isinstance(m, pnn.InstanceNorm2D)}
    normed |= {f"model.{i}.conv_block.{j - 1}.bias"
               for i, m in enumerate(g_cpu.model)
               if hasattr(m, "conv_block")
               for j, n in enumerate(m.conv_block)
               if isinstance(n, pnn.InstanceNorm2D)}
    worst, noise = 0.0, 0.0
    for k, g in res["cpu"]["grads"].items():
        if k in normed:
            noise = max(noise, float(res["cuda"]["grads"][k].abs().max()),
                        float(g.abs().max()))
            continue
        rel = float((res["cuda"]["grads"][k] - g).norm()
                    / g.norm().clamp(min=1e-12))
        worst = max(worst, rel)
        if not rel <= RESNET_KINK:
            raise AssertionError(f"cyclegan gradient {k}: relative L2 {rel}")
    if not noise <= CG_BIAS_NOISE:
        raise AssertionError(f"a bias in front of an instance norm has a "
                             f"gradient of {noise}")
    with torch.no_grad():
        a = C.build(paddle, cfg, seed=7)["G_A"].cuda()(x.cuda())
        b = C.build(paddle, cfg, seed=7, upsample="crop")["G_A"].cuda()(
            x.cuda())
    ok, form_err = close(a, b, **CG_TOL)
    if not ok:
        raise AssertionError(f"output_padding form vs crop form {form_err}")
    log(f"cyclegan generator (ngf 64, {CG_HOLD_BLOCKS} blocks, "
        f"{CG_HOLD_HW}^2) f32, card vs CPU: max abs {err:.3g} (limit "
        f"{CG_TOL}), gradients' worst relative L2 {worst:.3g} (limit "
        f"{RESNET_KINK}), the {len(normed)} biases in front of an "
        f"instance norm at most {noise:.3g} (exact: 0; limit "
        f"{CG_BIAS_NOISE}); output_padding form vs crop form on the "
        f"card: max abs {form_err:.3g}")
    return dict(out_max_abs=err, grads_rel_l2=worst, normed_bias_grad=noise,
                forms_max_abs=form_err)


@phase("cyclegan")
def cyclegan():
    """PaddleGAN's CycleGAN at horse2zebra's widths (B=1, 256^2, f32)
    through the port's 2.x API: two generators and two PatchGAN
    discriminators, Adam for each pair, the image pools; then the cut
    generator's holds."""
    C = _cg_program()
    cfg = C.HORSE2ZEBRA
    torch.cuda.empty_cache()
    # fixed shapes: cuDNN's search, as the resnet phase (without it the
    # f32 step took 243.76 ms against 97.47 on the H100: PERF.md)
    torch.backends.cudnn.benchmark = True
    paddle.set_device("cuda")
    t0 = time.perf_counter()
    with unique_name.guard():
        nets = {k: v.cuda() for k, v in C.build(paddle, cfg, seed=0).items()}
    opts, pool = C.optimizers(paddle, nets, cfg), C.pools(cfg, seed=0)
    real_a, real_b = (torch.from_numpy(a).cuda()
                      for a in C.images(cfg, seed=0))
    counts = {k: C.n_params(v) for k, v in nets.items()}
    log(f"cyclegan: parameters G_A {counts['G_A'] / 1e6:.3f} M, G_B "
        f"{counts['G_B'] / 1e6:.3f} M, D_A {counts['D_A'] / 1e6:.3f} M, "
        f"D_B {counts['D_B'] / 1e6:.3f} M; built in "
        f"{time.perf_counter() - t0:.1f} s; B={cfg['batch']} "
        f"{cfg['size']}^2 f32, Adam {cfg['lr']} (0.5, 0.999)")
    up = [m for m in nets["G_A"].modules()
          if isinstance(m, pnn.Conv2DTranspose)][0]
    seen = {}
    hook = up.register_forward_hook(
        lambda m, i, o: seen.__setitem__("edge", o[:, :, -1, :].detach()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in COUNTERS.values():
        c.reset()
    # -- the main path: counters at 0 before, read right after ---------------
    t0 = time.perf_counter()
    history = [C.train_step(paddle, nets, opts, pool, real_a, real_b, cfg)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    hook.remove()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with _SyncCount() as syncs:
        t0 = time.perf_counter()
        e0.record()
        for _ in range(CG_TIMED):
            history.append(C.train_step(paddle, nets, opts, pool, real_a,
                                        real_b, cfg))
        e1.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / CG_TIMED
    launches = {n: c.value for n, c in COUNTERS.items()}
    # --------------------------------------------------------------------------
    mem = torch.cuda.max_memory_allocated()
    step_ms = e0.elapsed_time(e1) / CG_TIMED
    sites = syncs.sites()
    losses = {k: [float(h[k].detach()) for h in history] for k in history[0]}
    cycle = [a + b for a, b in zip(losses["cycle_A"], losses["cycle_B"])]
    log("cyclegan losses: " + "; ".join(
        f"{k} {' '.join(f'{v:.4f}' for v in vs)}"
        for k, vs in losses.items()))
    _expect_launches(launches, 0, (), f"{CG_TIMED + 1} CycleGAN steps")
    if not all(np.isfinite(v).all() for v in losses.values()):
        raise AssertionError("a CycleGAN loss is not finite")
    if not cycle[-1] < cycle[0]:
        raise AssertionError(f"the cycle loss did not fall: {cycle}")
    for name, opt in opts.items():
        for st in opt._state.values():
            if not all(bool(torch.isfinite(v).all()) for v in st.values()):
                raise AssertionError(f"a {name} Adam moment is not finite")
    edge = float(seen["edge"].abs().max())
    if not edge > 0.0:
        raise AssertionError("the output_padding row of the first "
                             "upsampling is zero")
    syncs_per_step = sum(sites.values()) / CG_TIMED
    if syncs_per_step:
        raise AssertionError(f"{syncs_per_step} host syncs a step at {sites}")
    busy, wall, top = _profile(lambda: C.train_step(
        paddle, nets, opts, pool, real_a, real_b, cfg), top=10)
    summary = dict(step_ms=step_ms, host_step_ms=host_ms,
                   images_per_s=2 * cfg["batch"] / (step_ms / 1e3),
                   warmup_step_s=warm_s, max_memory_allocated_bytes=mem,
                   syncs_per_step=syncs_per_step, parameters=counts,
                   output_padding_row_max_abs=edge, losses=losses,
                   profiled_busy_ms=busy, profiled_wall_ms=wall,
                   profiled_idle=max(0.0, 1 - busy / wall),
                   top_kernels=[dict(name=k[:90], ms=ms, count=n)
                                for k, ms, n in top])
    log(f"cyclegan step B={cfg['batch']} {cfg['size']}^2 f32: "
        f"{step_ms:.3f} ms (CUDA events; host clock {host_ms:.3f} ms), "
        f"{summary['images_per_s']:.2f} images/s (one A and one B image "
        f"a step), max_memory_allocated {mem / 2 ** 30:.2f} GiB, host "
        f"syncs a step {syncs_per_step:.2f}; the first upsampling's "
        f"output_padding row max |.| {edge:.4g}")
    del nets, opts, pool
    torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = False
    summary["hold"] = _cg_hold(C)
    summary["card"] = card_line()
    log("cyclegan summary: " + json.dumps(summary))
    return launches


# -- the fluid_amp phase: static ResNet-50 in fp16 with LARS, recompute,
# -- the optimizer zoo and the random rules --------------------------------

def _amp_program():
    """tests/torch_fluid_amp_program.py, the JAX-free program the parity
    tests hold against paddle_tpu."""
    tests = str(Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_fluid_amp_program as AP
    return AP


def _state_clone(scope):
    return {n: scope.get(n).clone() for n in scope.local_var_names()}


def _amp_ema_check(fluid, exe, scope, main, feed, ema, fetches):
    """Inside ema.apply() every parameter is its bias-corrected shadow
    (bit for bit) and the for_test clone runs on them; after restore()
    each is the training tensor itself again."""
    trained = {n: scope.get(n) for n in ema._shadow}
    corr = 1.0 - ema._decay_prod
    test = main.clone(for_test=True)
    with fluid.scope_guard(scope), ema.apply():
        bad = [n for n, avg in ema._shadow.items()
               if not torch.equal(scope.get(n),
                                  (avg / corr).to(trained[n].dtype))]
        loss = float(exe.run(test, feed=feed, fetch_list=fetches[:1],
                             scope=scope)[0])
    moved = [n for n in trained if scope.get(n) is not trained[n]]
    if bad or moved or not np.isfinite(loss):
        raise AssertionError(f"EMA: {len(bad)} shadows not applied, "
                             f"{len(moved)} not restored, eval loss {loss}")
    log(f"EMA(0.9999) over {ema._step} updates: {len(trained)} shadows "
        f"applied bit for bit (bias correction 1 - {ema._decay_prod:.6f}),"
        f" the for_test clone's loss on them {loss:.4f}, every parameter "
        f"restored to its training tensor")
    return loss


def _amp_run(fluid, R, AP):
    """The AMP + LARS program at full width: warm-up, AMP_TIMED steps by
    CUDA events with the host syncs counted by line, AMP_STEPS in all;
    the loss scale's trajectory against its rule; EMA."""
    opt = AP.amp_optimizer(fluid)
    t0 = time.perf_counter()
    main, startup, _, fetches = AP.build(
        fluid, R, unique_name, opt, class_num=FLUID_CLASSES,
        image_shape=(3, FLUID_HW, FLUID_HW), batch_size=FLUID_BATCH)
    built_s = time.perf_counter() - t0
    names = list(AP.amp_state_names(main, opt))
    block = main.global_block()
    n_ops, n_sub = len(block.ops), len(main.blocks[1].ops)
    casts = sum(op.type == "cast" for op in block.ops)
    params = [p for p in main.all_parameters() if p.trainable]
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"image": torch.from_numpy(rng.randn(
                FLUID_BATCH, 3, FLUID_HW, FLUID_HW).astype("float32")).cuda(),
            "label": torch.from_numpy(rng.randint(
                0, FLUID_CLASSES, (FLUID_BATCH, 1)).astype("int64")).cuda()}
    ema = fluid.optimizer.ExponentialMovingAverage(0.9999)
    fetch = fetches + names
    log(f"static resnet50 fp16 + LARS (lr {AP.LR}, fleet's lars_configs) "
        f"+ dynamic loss scaling (fleet's amp_configs): {len(params)} "
        f"parameters, {n_ops} ops a step ({casts} casts) + {n_sub} in the "
        f"update's conditional block; built in {built_s:.1f} s")

    ema_s = [0.0]

    def run():
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                      return_numpy=False)
        t = time.perf_counter()
        ema.update(scope, main)
        ema_s[0] += time.perf_counter() - t
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    profiler.stat_reset()
    profiler.time_reset()
    for c in COUNTERS.values():
        c.reset()
    # -- the main path: counters at 0 before, read right after --------------
    out = []
    t0 = time.perf_counter()
    out.append(run())  # warm-up (cuDNN's algorithm search)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    reads0 = profiler.get_int_stats().get("control_flow_host_reads", 0)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with _SyncCount() as sc:
        ema_s[0] = 0.0
        h0 = time.perf_counter()
        e0.record()
        for _ in range(AMP_TIMED):
            out.append(run())
        e1.record()
        host_s = time.perf_counter() - h0
        ema_ms = ema_s[0] * 1e3 / AMP_TIMED
    torch.cuda.synchronize()
    timed_reads = profiler.get_int_stats().get(
        "control_flow_host_reads", 0) - reads0
    sites = sc.sites()
    for _ in range(AMP_STEPS - AMP_TIMED):
        out.append(run())
    torch.cuda.synchronize()
    mem = torch.cuda.max_memory_allocated()
    launches = {n: c.value for n, c in COUNTERS.items()}
    stats_all = profiler.get_int_stats()
    # ------------------------------------------------------------------------
    _expect_launches(launches, 0, (), f"{len(out)} static AMP steps")
    step_ms = e0.elapsed_time(e1) / AMP_TIMED
    host_ms = host_s * 1e3 / AMP_TIMED
    ops_run = stats_all.get("executor_op_count", 0) / len(out)
    losses = [float(o[0]) for o in out]
    rows = [(float(o[2].numpy()[0]), int(o[3].numpy()[0]),
             int(o[4].numpy()[0]), bool(o[5].numpy()[0])) for o in out]
    found = [r[3] for r in rows]
    replay = AP.replay_loss_scaling(found)
    if [r[:3] for r in rows] != replay:
        raise AssertionError(f"loss scaling {rows} is not its rule's "
                             f"replay {replay}")
    syncs = sum(sites.values())
    if timed_reads != AMP_TIMED or syncs != AMP_TIMED:
        raise AssertionError(f"{timed_reads} host reads and {syncs} syncs "
                             f"({sites}) in {AMP_TIMED} steps, want 1 each "
                             f"a step (the conditional block's condition)")
    applied = [l for l, f in zip(losses, found) if not f]
    if len(applied) < AMP_MIN_APPLIED or not all(np.isfinite(applied)) \
            or not applied[-1] < applied[0]:
        raise AssertionError(f"{len(applied)} steps applied an update, "
                             f"their losses {applied} do not fall")
    log(f"losses: {' '.join(f'{v:.4f}' for v in losses)}")
    log(f"loss scale after each step: "
        f"{' '.join(f'{r[0]:g}' for r in rows)}; good / bad counts "
        f"{[r[1:3] for r in rows]}; {sum(found)} of {len(found)} steps "
        f"skipped (overflow), as the update_loss_scaling rule replays")
    flops = 3 * VT.resnet50_fwd_flops(FLUID_BATCH, FLUID_HW, FLUID_CLASSES)
    summary = dict(
        step_ms=step_ms, host_step_ms=host_ms,
        images_per_s=FLUID_BATCH / (step_ms / 1e3),
        mfu_bf16_peak=flops / (step_ms / 1e3) / PEAK_BF16_FLOPS,
        ops_per_step=ops_run, program_ops=n_ops, update_block_ops=n_sub,
        casts=casts, host_us_per_op=1e3 * host_ms / ops_run,
        host_reads_per_step=timed_reads / AMP_TIMED,
        ema_update_host_ms=ema_ms,
        syncs_per_step=syncs / AMP_TIMED, sync_sites=sites,
        warmup_step_s=warm_s, max_memory_allocated_bytes=mem,
        losses=losses, loss_scale=[r[0] for r in rows],
        good_steps=[r[1] for r in rows], bad_steps=[r[2] for r in rows],
        skipped=sum(found), applied=len(applied), lr=AP.LR)
    log(f"static resnet50 fp16 train step B={FLUID_BATCH}: {step_ms:.3f} ms "
        f"(CUDA events over {AMP_TIMED} steps, EMA update included; host "
        f"clock {host_ms:.3f} ms), {summary['images_per_s']:.1f} images/s, "
        f"MFU {100 * summary['mfu_bf16_peak']:.2f}% of 989 TFLOP/s; "
        f"{ops_run:.1f} ops a step at {summary['host_us_per_op']:.1f} host "
        f"us an op (EMA's update {ema_ms:.3f} host ms of it); host reads {summary['host_reads_per_step']:.2f} and "
        f"syncs {summary['syncs_per_step']:.2f} a step ({sites}); "
        f"max_memory_allocated {mem / 2 ** 30:.2f} GiB; warm-up "
        f"{warm_s:.2f} s")
    busy, wall, top = _profile(lambda: run()[0].torch(), top=12)
    summary.update(profiled_busy_ms=busy, profiled_wall_ms=wall,
                   profiled_idle=max(0.0, 1 - busy / wall),
                   top_kernels=[dict(name=k[:90], ms=ms, count=n)
                                for k, ms, n in top])
    summary["ema_eval_loss"] = _amp_ema_check(fluid, exe, scope, main,
                                              feed, ema, fetches)
    summary["injected_overflow"] = _amp_skip_check(exe, scope, main, feed,
                                                   names, params, AP)
    return launches, summary, feed


def _amp_skip_check(exe, scope, main, feed, names, params, AP):
    """Two more steps with the loss scale at float32's largest value and
    the counts at 0: the scaled loss overflows, so every gradient does,
    the update's block is skipped and each parameter and velocity stays
    bit for bit; the first step counts one bad step and keeps the scale,
    the second halves it (decr_every_n_nan_or_inf is 2), as the
    update_loss_scaling rule replays."""
    scale, good, bad, found = names
    keep = [p.name for p in params] + [n for n in scope.local_var_names()
                                       if n.endswith("_velocity_0")]
    before = {n: scope.get(n).clone() for n in keep}
    top = float(np.finfo(np.float32).max)
    scope.set(scale, torch.full_like(scope.get(scale), top))
    scope.set(good, torch.zeros_like(scope.get(good)))
    scope.set(bad, torch.zeros_like(scope.get(bad)))
    rows = []
    for _ in range(2):
        got = exe.run(main, feed=feed, fetch_list=[scale, good, bad, found],
                      scope=scope)
        rows.append((float(got[0][0]), int(got[1][0]), int(got[2][0]),
                     bool(got[3][0])))
    want = [r + (True,) for r in AP.replay_loss_scaling(
        [True, True], dict(AP.AMP, init_loss_scaling=top))]
    changed = [n for n in keep if not torch.equal(scope.get(n), before[n])]
    if rows != want or changed:
        raise AssertionError(f"two overflowing steps: (scale, good, bad, "
                             f"found) {rows}, the rule's {want}; "
                             f"{len(changed)} of {len(keep)} vars moved")
    log(f"two injected overflows (loss scale {top:g}) skip the update on "
        f"the card: {len(keep)} parameters and velocities unchanged bit "
        f"for bit; (scale, good, bad, found) {rows}, the rule's replay")
    return dict(vars_unchanged=len(keep), rows=rows)


def _amp_cut_check(fluid, R, AP):
    """The decorated program (LARS, dynamic loss scaling) on the cut
    resnet18 (width 8, B=8, 32 x 32), AMP_CUT_STEPS steps on the card's
    Executor against the CPU's, each from the CPU's state, in two forms.
    f32: every white-listed op moved to the black list, so the scaled,
    checked and unscaled gradients and the conditional update run in
    float32: the loss within FLUID_LOSS_RTOL and every float state var
    within RESNET_KINK, as the fluid phase holds resnet18.  fp16: the
    same overflow flags, scales and counts, the loss within AMP_CUT_LOSS
    (tests/test_torch_fluid_amp.py's fp16 tolerance); its updates are
    reported and not bounded, since each device rounds every fp16
    convolution's inputs and outputs and the ReLUs and the batch
    statistics of 8 images move whole terms of a gradient on a rounding."""
    from paddle_tpu_torch.convert import load_jax_scope

    black = fluid.contrib.mixed_precision.AutoMixedPrecisionLists(
        custom_black_list=["conv2d", "mul", "matmul"])
    forms = {"f32": dict(amp_lists=black), "fp16": {}}
    out = {}
    for form, kw in forms.items():
        opt = fluid.contrib.mixed_precision.decorate(
            fluid.optimizer.LarsMomentumOptimizer(AP.LR, **AP.LARS),
            dtype="float16", **kw, **AP.AMP)
        main, startup, _, fetches = AP.build(
            fluid, R, unique_name, opt, depth=18, class_num=10,
            image_shape=(3, 32, 32), batch_size=8, width=8)
        names = list(AP.amp_state_names(main, opt))
        params = [p.name for p in main.all_parameters() if p.trainable]
        gpu, cpu = fluid.Executor(), fluid.Executor(fluid.CPUPlace())
        gs, cs = fluid.Scope(), fluid.Scope()
        gpu.run(startup, scope=gs)
        cpu.run(startup, scope=cs)
        load_jax_scope(cs, {n: gs.get(n).cpu().numpy()
                            for n in gs.local_var_names()})
        rng = np.random.RandomState(0)
        loss_tol = AMP_CUT_LOSS if form == "fp16" else dict(
            rtol=FLUID_LOSS_RTOL, atol=0.0)
        loss_err, state_err, update_err, found = 0.0, {}, 0.0, []
        for step in range(AMP_CUT_STEPS):
            feed = {"image": rng.rand(8, 3, 32, 32).astype("float32"),
                    "label": rng.randint(0, 10, (8, 1)).astype("int64")}
            load_jax_scope(gs, {n: cs.get(n).numpy()
                                for n in cs.local_var_names()})
            before = {n: cs.get(n).double() for n in params}
            g = gpu.run(main, feed=feed, fetch_list=fetches[:1] + names,
                        scope=gs)
            c = cpu.run(main, feed=feed, fetch_list=fetches[:1] + names,
                        scope=cs)
            gl, cl = float(g[0]), float(c[0])
            loss_err = max(loss_err, abs(gl - cl) / abs(cl))
            rows = [[np.asarray(v).tolist() for v in r[1:]] for r in (g, c)]
            if not np.isfinite(gl) or abs(gl - cl) > loss_tol["atol"] \
                    + loss_tol["rtol"] * abs(cl) or rows[0] != rows[1]:
                raise AssertionError(f"{form} step {step}: card loss {gl} "
                                     f"vs CPU {cl}, (scale, good, bad, "
                                     f"found) {rows}")
            found.append(bool(rows[1][3][0]))
            num = den = 0.0
            for n in params:
                d = gs.get(n).double().cpu() - before[n]
                w = cs.get(n).double() - before[n]
                num += float((d - w).norm()) ** 2
                den += float(w.norm()) ** 2
            if den:
                update_err = max(update_err, (num / den) ** 0.5)
            for n, e in _fluid_state_errors(gs, cs).items():
                state_err[n] = max(state_err.get(n, 0.0), e)
        var, err = max(state_err.items(), key=lambda kv: kv[1])
        if form == "f32" and (err > RESNET_KINK or any(found)):
            raise AssertionError(f"f32-decorated cut resnet18: {var} "
                                 f"relative L2 {err}, found {found}")
        out[form] = dict(loss_rel=loss_err, update_rel_l2=update_err,
                         worst_var=var, worst_rel_l2=err, found=found)
        log(f"the decorated cut resnet18 ({form}, LARS, loss scaling), "
            f"card vs CPU Executor over {AMP_CUT_STEPS} steps each from "
            f"the CPU's state: loss {loss_err:.2e} (limit {loss_tol}), the "
            f"same flags {found}, scales and counts; the whole update's "
            f"relative L2 {update_err:.2e}, the worst of {len(state_err)} "
            f"state vars {var} {err:.2e}"
            + (f" (limit {RESNET_KINK})" if form == "f32" else ""))
    return out


def _rel_update(after, before, ref_after):
    """Relative L2 of one update against another's, from one state."""
    d, w = (after - before).double(), (ref_after - before).double()
    return float((d - w).norm()) / max(float(w.norm()), 1e-12)


def _amp_recompute(fluid, R, AP, feed):
    """The f32 program with the configs[1] Momentum, plain and wrapped in
    RecomputeOptimizer (checkpoints: the 16 blocks' outputs), one step
    each from one state after a warm-up step each: the same loss
    (RECOMPUTE_LOSS_RTOL), each parameter's update within
    RECOMPUTE_UPDATE_L2, a lower peak."""
    def momentum():
        return fluid.optimizer.Momentum(
            learning_rate=0.1, momentum=0.9,
            regularization=fluid.regularizer.L2Decay(1e-4))

    forms = {}
    for name, opt in (("plain", momentum()),
                      ("recompute", AP.recompute_optimizer(fluid,
                                                           momentum()))):
        main, startup, _, fetches = AP.build(
            fluid, R, unique_name, opt, class_num=FLUID_CLASSES,
            image_shape=(3, FLUID_HW, FLUID_HW), batch_size=FLUID_BATCH)
        forms[name] = (main, startup, fetches)
    n_seg = sum(op.type == "recompute_segment_grad"
                for op in forms["recompute"][0].global_block().ops)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(forms["plain"][1], scope=scope)
    state0 = _state_clone(scope)
    got = {}
    for name, (main, _, fetches) in forms.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        times, peaks = [], []
        # a warm-up (cuDNN's search), then RECOMPUTE_STEPS steps, each
        # from the same state
        for i in range(1 + RECOMPUTE_STEPS):
            for n, v in state0.items():
                scope.set(n, v.clone())
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            e0, e1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            e0.record()
            loss = exe.run(main, feed=feed, fetch_list=fetches[:1],
                           scope=scope, return_numpy=False)[0]
            e1.record()
            torch.cuda.synchronize()
            if i:
                times.append(e0.elapsed_time(e1))
                peaks.append(torch.cuda.max_memory_allocated())
        got[name] = dict(loss=float(loss), ms=float(np.median(times)),
                         ms_each=times, peak=max(peaks),
                         peak_over_state=max(peaks) - base,
                         state=_state_clone(scope))
    params = [p.name for p in forms["plain"][0].all_parameters()
              if p.trainable]
    worst = max((_rel_update(got["recompute"]["state"][n], state0[n],
                             got["plain"]["state"][n]), n) for n in params)
    rel = abs(got["recompute"]["loss"] - got["plain"]["loss"]) \
        / abs(got["plain"]["loss"])
    log(f"recompute ({n_seg} segments) vs plain, f32 Momentum, one step "
        f"from one state: loss {got['recompute']['loss']:.6f} / "
        f"{got['plain']['loss']:.6f} (rel {rel:.2e}, limit "
        f"{RECOMPUTE_LOSS_RTOL}); worst update {worst[1]} rel L2 "
        f"{worst[0]:.2e} (limit {RECOMPUTE_UPDATE_L2}); step (median of "
        f"{RECOMPUTE_STEPS}) {got['recompute']['ms']:.3f} / "
        f"{got['plain']['ms']:.3f} ms; peak "
        f"{got['recompute']['peak'] / 2 ** 30:.2f} / "
        f"{got['plain']['peak'] / 2 ** 30:.2f} GiB (above the state: "
        f"{got['recompute']['peak_over_state'] / 2 ** 30:.2f} / "
        f"{got['plain']['peak_over_state'] / 2 ** 30:.2f})")
    if not rel <= RECOMPUTE_LOSS_RTOL or worst[0] > RECOMPUTE_UPDATE_L2 \
            or not got["recompute"]["peak"] < got["plain"]["peak"]:
        raise AssertionError("recompute does not match the plain step, or "
                             "does not peak lower")
    return {k: {m: v for m, v in g.items() if m != "state"}
            for k, g in got.items()} | dict(
        segments=n_seg, loss_rel=rel, worst_update=worst[1],
        worst_update_rel_l2=worst[0])


def _zoo(fluid):
    """name -> the optimizer (wrapper) to minimize with: the sixteen
    update optimizers, ClipGradByGlobalNorm on Momentum, ModelAverage on
    Adam, Lookahead on Lamb.  Dpsgd at sigma 0 (its noise is held by its
    statistics)."""
    O = fluid.optimizer
    return {
        "SGD": lambda: O.SGD(0.05),
        "Momentum": lambda: O.Momentum(0.05, 0.9),
        "LarsMomentum": lambda: O.LarsMomentum(2.0, 0.9),
        "Adagrad": lambda: O.Adagrad(0.01),
        "Adam": lambda: O.Adam(0.001),
        "AdamW": lambda: O.AdamW(0.001, weight_decay=0.01),
        "Adamax": lambda: O.Adamax(0.001),
        "Adadelta": lambda: O.Adadelta(1.0),
        "RMSProp": lambda: O.RMSProp(0.001, momentum=0.9),
        "Lamb": lambda: O.Lamb(0.001),
        "DGCMomentum": lambda: O.DGCMomentum(0.05, 0.9, sparsity=[0.99]),
        "DecayedAdagrad": lambda: O.DecayedAdagrad(0.01),
        "ProximalGD": lambda: O.ProximalGD(
            0.05, l1_regularization_strength=1e-4),
        "ProximalAdagrad": lambda: O.ProximalAdagrad(
            0.01, l1_regularization_strength=1e-4),
        "Ftrl": lambda: O.Ftrl(0.01, l1=1e-4),
        "Dpsgd": lambda: O.Dpsgd(0.05, clip=10.0, batch_size=8.0,
                                 sigma=0.0),
        "Momentum+ClipGradByGlobalNorm": lambda: O.Momentum(
            0.05, 0.9, grad_clip=fluid.clip.ClipGradByGlobalNorm(1.0)),
        "Adam+ModelAverage": lambda: O.Adam(0.001),
        "Lookahead(Lamb)": lambda: O.LookaheadOptimizer(O.Lamb(0.001),
                                                        alpha=0.5, k=2),
    }


def _optimizer_zoo(fluid, R):
    """Each optimizer of _zoo on the cut resnet18 (width 8, B=8, 32 x
    32): ZOO_STEPS steps on the card's Executor against the CPU's, each
    from the CPU's state; the loss within FLUID_LOSS_RTOL, every float
    state var within RESNET_KINK (as the fluid phase holds resnet18),
    and ModelAverage's averages within RESNET_KINK."""
    from paddle_tpu_torch.convert import load_jax_scope

    rng = np.random.RandomState(0)
    feed = {"image": rng.rand(8, 3, 32, 32).astype("float32"),
            "label": rng.randint(0, 10, (8, 1)).astype("int64")}
    worst = {}
    for name, make in _zoo(fluid).items():
        with unique_name.guard():
            main, startup, _, fetches = R.build_train_program(
                depth=18, class_num=10, image_shape=(3, 32, 32),
                batch_size=8, width=8, optimizer=make())
        gpu, cpu = fluid.Executor(), fluid.Executor(fluid.CPUPlace())
        gs, cs = fluid.Scope(), fluid.Scope()
        gpu.run(startup, scope=gs)
        cpu.run(startup, scope=cs)
        load_jax_scope(cs, {n: gs.get(n).cpu().numpy()
                            for n in gs.local_var_names()})
        avg = {s: fluid.optimizer.ModelAverage(0.15) for s in ("g", "c")} \
            if "ModelAverage" in name else None
        loss_err, state_err = 0.0, {}
        for _ in range(ZOO_STEPS):
            load_jax_scope(gs, {n: cs.get(n).numpy()
                                for n in cs.local_var_names()})
            g = float(gpu.run(main, feed=feed, fetch_list=fetches[:1],
                              scope=gs)[0])
            c = float(cpu.run(main, feed=feed, fetch_list=fetches[:1],
                              scope=cs)[0])
            loss_err = max(loss_err, abs(g - c) / abs(c))
            if not np.isfinite(g) or loss_err > FLUID_LOSS_RTOL:
                raise AssertionError(f"{name}: card loss {g} vs CPU {c}")
            for n, e in _fluid_state_errors(gs, cs).items():
                state_err[n] = max(state_err.get(n, 0.0), e)
            if avg is not None:
                avg["g"].update(gs, main)
                avg["c"].update(cs, main)
        if avg is not None:
            for n, a in avg["c"]._shadow.items():
                w, d = a.double(), avg["g"]._shadow[n].double().cpu()
                state_err["average:" + n] = float((d - w).norm()) / max(
                    float(w.norm()), 1e-6 * w.numel() ** 0.5)
        var, err = max(state_err.items(), key=lambda kv: kv[1])
        worst[name] = dict(loss_rel=loss_err, worst_var=var,
                           worst_rel_l2=err, state_vars=len(state_err))
        if err > RESNET_KINK:
            raise AssertionError(f"{name}: {var} relative L2 {err}")
    log(f"optimizer zoo on the cut resnet18, card vs CPU Executor over "
        f"{ZOO_STEPS} steps each from the CPU's state (loss limit "
        f"{FLUID_LOSS_RTOL}, state limit {RESNET_KINK}):")
    for name, w in worst.items():
        log(f"  {name:32s} loss {w['loss_rel']:.2e}, worst of "
            f"{w['state_vars']} vars {w['worst_var']} {w['worst_rel_l2']:.2e}")
    return worst


def _chi2_limit(k):
    """The 1 - 1e-6 quantile of a chi-square of k degrees of freedom
    (Wilson-Hilferty)."""
    return k * (1 - 2 / (9 * k) + 4.753 * (2 / (9 * k)) ** 0.5) ** 3


def _random_rules():
    """The random and drawing rules on the card at RANDOM_DRAWS draws,
    by their statistics (5 standard errors; chi-square below its 1 -
    1e-6 quantile), and shuffle_channel equal to the CPU's exactly."""
    from math import erf, exp, pi, sqrt

    from paddle_tpu_torch.fluid.framework import Operator, Program
    from paddle_tpu_torch.ops import registry

    blk = Program().global_block()

    def rule(op_type, ins, attrs, slot="Out", device="cuda", seed=7):
        op = Operator(blk, 11, op_type, {s: [s] for s in ins},
                      {slot: [slot]}, attrs)
        out = registry.forward_rule(op_type)(
            registry.LowerCtx(seed, device=device), op,
            {s: [v] for s, v in ins.items()})[slot][0]
        if device == "cuda" and out.device.type != "cuda":
            raise AssertionError(f"{op_type} ran off the card")
        return out

    def within(name, x, mean, std):
        n = x.numel()
        m, s = float(x.double().mean()), float(x.double().std())
        if abs(m - mean) > 5 * std / n ** 0.5 \
                or abs(s - std) > 5 * std / (2 * n) ** 0.5:
            raise AssertionError(f"{name}: mean {m} std {s}, want {mean} "
                                 f"{std}")
        return dict(mean=m, std=s)

    def chi2(name, counts, probs):
        exp_ = counts.sum() * probs
        stat = float(((counts - exp_) ** 2 / exp_).sum())
        if stat > _chi2_limit(len(counts) - 1):
            raise AssertionError(f"{name}: chi-square {stat}")
        return stat

    n = RANDOM_DRAWS
    out = {}
    t = rule("truncated_gaussian_random", {},
             {"shape": [n], "mean": -1.0, "std": 3.0, "dtype": "float32"})
    phi2 = exp(-2.0) / sqrt(2 * pi)
    std = 3.0 * sqrt(1 - 4 * phi2 / erf(2 / sqrt(2)))
    if float(t.min()) < -7.0 or float(t.max()) > 5.0:
        raise AssertionError("truncated_gaussian_random beyond 2 std")
    out["truncated_gaussian_random"] = within("truncated", t, -1.0, std)
    perm = rule("randperm", {}, {"n": n})
    if not torch.equal(torch.sort(perm).values,
                       torch.arange(n, device="cuda")):
        raise AssertionError("randperm is not a permutation")
    out["randperm"] = "a permutation of 10^6"
    ri = rule("randint", {}, {"shape": [n], "low": -3, "high": 5,
                              "dtype": "int64"})
    if int(ri.min()) < -3 or int(ri.max()) > 4:
        raise AssertionError("randint out of range")
    out["randint_chi2"] = chi2("randint", torch.bincount(
        ri + 3, minlength=8).cpu().double().numpy(), np.full(8, 1 / 8))
    p = torch.tensor([0.05, 0.3, 0.5, 0.9], device="cuda")
    b = rule("bernoulli", {"X": p.repeat(n // 4, 1)}, {})
    means = b.mean(0).tolist()
    for pj, mj in zip(p.tolist(), means):
        if abs(mj - pj) > 5 * (pj * (1 - pj) / (n // 4)) ** 0.5:
            raise AssertionError(f"bernoulli mean {mj} for p {pj}")
    out["bernoulli_means"] = means
    w = torch.tensor([1.0, 2.0, 3.0, 4.0, 0.5], device="cuda")
    for rep in (True, False):
        m = rule("multinomial", {"X": w.repeat(n // 4, 1)},
                 {"num_samples": 4 if rep else 3, "replacement": rep})
        first = m.reshape(-1) if rep else m[:, 0]
        out[f"multinomial_chi2_{'with' if rep else 'without'}"] = chi2(
            "multinomial", torch.bincount(first, minlength=5).cpu()
            .double().numpy(), (w / w.sum()).cpu().double().numpy())
        if not rep and not bool((m[:, 0] != m[:, 1]).all()
                                & (m[:, 1] != m[:, 2]).all()
                                & (m[:, 0] != m[:, 2]).all()):
            raise AssertionError("multinomial drew a category twice")
    sid = rule("sampling_id", {"X": (w / w.sum()).repeat(n // 5, 1)}, {})
    out["sampling_id_chi2"] = chi2("sampling_id", torch.bincount(
        sid, minlength=5).cpu().double().numpy(),
        (w / w.sum()).cpu().double().numpy())
    like = torch.empty(1000, 3, device="cuda")
    out["uniform_random_batch_size_like"] = within(
        "uniform_bsl", rule("uniform_random_batch_size_like",
                            {"Input": like},
                            {"shape": [-1, n // 1000], "min": -2.0,
                             "max": 4.0}), 1.0, 6.0 / 12 ** 0.5)
    out["gaussian_random_batch_size_like"] = within(
        "gaussian_bsl", rule("gaussian_random_batch_size_like",
                             {"Input": like},
                             {"shape": [-1, n // 1000], "mean": 0.5,
                              "std": 2.0}), 0.5, 2.0)
    z = torch.zeros(n, device="cuda")
    out["dpsgd_noise"] = within("dpsgd", rule(
        "dpsgd", {"Param": z, "Grad": z,
                  "LearningRate": torch.ones(1, device="cuda")},
        {"clip": 1.5, "batch_size": 4.0, "sigma": 2.0}, slot="ParamOut"),
        0.0, 2.0 * 1.5 / 4.0)
    x = torch.randn(128, 64, 28, 28, device="cuda")
    sc = rule("shuffle_channel", {"X": x}, {"group": 4})
    if not torch.equal(sc.cpu(), rule("shuffle_channel", {"X": x.cpu()},
                                      {"group": 4}, device="cpu")):
        raise AssertionError("shuffle_channel differs from the CPU")
    out["shuffle_channel"] = "equal to the CPU"
    log(f"random rules on the card at {n} draws: {json.dumps(out)}")
    return out


@phase("fluid_amp")
def fluid_amp():
    """BASELINE configs[1]'s static ResNet-50 program
    (tests/torch_fluid_amp_program.py: models/resnet.build_train_program
    at its defaults, B=128, 224^2) trained in fp16 through
    fluid.contrib.mixed_precision.decorate(LarsMomentumOptimizer) with
    dynamic loss scaling, EMA(0.9999) updated each step; then the f32
    program plain and under RecomputeOptimizer; the optimizer zoo and the
    decorated fp16 program on the cut resnet18 against the CPU; the
    random rules at 10^6 draws."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import resnet as R

    AP = _amp_program()
    torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = True
    try:
        launches, summary, feed = _amp_run(fluid, R, AP)
        torch.cuda.empty_cache()
        summary["recompute"] = _amp_recompute(fluid, R, AP, feed)
        del feed
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.benchmark = False
    summary["zoo"] = _optimizer_zoo(fluid, R)
    summary["cut_fp16"] = _amp_cut_check(fluid, R, AP)
    summary["random"] = _random_rules()
    summary["card"] = card_line()
    log("fluid_amp summary: " + json.dumps(summary))
    return launches


# -- MobileNet-SSD with its detection and quantize rules (phase 23) -----------

def _ssd_modules():
    """tests/torch_ssd_program.py and tests/torch_det_cases.py, the
    JAX-free program and rule cases the parity tests hold against
    paddle_tpu."""
    tests = str(Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_det_cases as C
    import torch_ssd_program as S
    return S, C


def _ssd_train(fluid, S, quant=False):
    """The full-width program (quantization-aware with `quant`) through
    fluid.Executor: a warm-up, then the timed steps by CUDA events with
    the host syncs counted by line and the host reads by the Executor's
    counter, more to the step count; the loss finite and falling, 0
    reads and syncs a step, no hand-written kernel launched.  Returns
    (launches, summary, (exe, scope, feed, out, main))."""
    cfg = S.FULL
    t0 = time.perf_counter()
    main, startup, out = S.build(fluid, cfg, quant=quant)
    built_s = time.perf_counter() - t0
    ops = main.global_block().ops
    n_quant = sum(op.type.startswith("fake_") and not op.type.endswith(
        "_grad") for op in ops)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    host_feed = S.batch(cfg, seed=0)
    feed = {k: torch.from_numpy(v).cuda() for k, v in host_feed.items()}
    loss = out["loss"].name

    def run():
        return exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)

    timed = SSD_QAT_STEPS if quant else SSD_TIMED
    total = SSD_QAT_STEPS + 1 if quant else SSD_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    profiler.stat_reset()
    for c in COUNTERS.values():
        c.reset()
    # -- the main path: counters at 0 before, read right after --------------
    t0 = time.perf_counter()
    fetched = [run()]  # warm-up (cuDNN's algorithm search)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    stats0 = profiler.get_int_stats()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with _SyncCount() as sc:
        h0 = time.perf_counter()
        e0.record()
        for _ in range(timed):
            fetched.append(run())
        e1.record()
        host_s = time.perf_counter() - h0
    torch.cuda.synchronize()
    stats1 = profiler.get_int_stats()
    sites = sc.sites()
    while len(fetched) < total:
        fetched.append(run())
    torch.cuda.synchronize()
    mem = torch.cuda.max_memory_allocated()
    launches = {n: c.value for n, c in COUNTERS.items()}
    # ------------------------------------------------------------------------
    what = f"{len(fetched)} ssd{' qat' if quant else ''} steps"
    _expect_launches(launches, 0, (), what)
    reads = stats1.get("control_flow_host_reads", 0) - stats0.get(
        "control_flow_host_reads", 0)
    ops_run = (stats1.get("executor_op_count", 0)
               - stats0.get("executor_op_count", 0)) / timed
    losses = [float(o[0]) for o in fetched]
    syncs = sum(sites.values())
    if reads or syncs:
        raise AssertionError(f"{what}: {reads} host reads and {syncs} syncs "
                             f"({sites}) in {timed} timed steps, want 0")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: losses {losses}")
    step_ms = e0.elapsed_time(e1) / timed
    host_ms = host_s * 1e3 / timed
    summary = dict(
        step_ms=step_ms, host_step_ms=host_ms,
        images_per_s=cfg["batch"] / (step_ms / 1e3), ops_per_step=ops_run,
        program_ops=len(ops), quant_ops=n_quant,
        host_us_per_op=1e3 * host_ms / ops_run, host_reads_per_step=0.0,
        syncs_per_step=0.0, warmup_step_s=warm_s, built_s=built_s,
        max_memory_allocated_bytes=mem, losses=losses)
    log(f"losses: {' '.join(f'{v:.4f}' for v in losses)}")
    log(f"mobilenet-ssd{' qat' if quant else ''} B={cfg['batch']} "
        f"{cfg['image']}^2 f32 through fluid.Executor: {step_ms:.3f} ms a "
        f"step (CUDA events over {timed} steps; host clock {host_ms:.3f} "
        f"ms), {summary['images_per_s']:.1f} images/s, {ops_run:.0f} ops a "
        f"step at {summary['host_us_per_op']:.1f} host us an op, {n_quant} "
        f"quant ops, host reads and syncs a step 0, max_memory_allocated "
        f"{mem / 2 ** 30:.2f} GiB, warm-up {warm_s:.2f} s, built in "
        f"{built_s:.1f} s")
    busy, wall, top = _profile(lambda: run(), top=12)
    summary.update(profiled_busy_ms=busy, profiled_wall_ms=wall,
                   profiled_idle=max(0.0, 1 - busy / wall),
                   top_kernels=[dict(name=k[:90], ms=ms, count=n)
                                for k, ms, n in top])
    if quant:
        scales = {n: scope.get(n) for n in scope.local_var_names()
                  if ".quant_scale" in n}
        vals = torch.cat([t.reshape(-1) for t in scales.values()]).cpu()
        if not (torch.isfinite(vals).all() and (vals > 0).all()):
            raise AssertionError(f"observer scales {vals.tolist()}")
        summary.update(observer_scales=len(scales),
                       scale_min=float(vals.min()),
                       scale_max=float(vals.max()))
        log(f"qat observers: {len(scales)} scales after {len(fetched)} "
            f"steps, in [{float(vals.min()):.4g}, {float(vals.max()):.4g}]")
    return launches, summary, (exe, scope, feed, out, main)


def _ssd_decode(fluid, S, exe, scope, feed):
    """The decode program on the trained scope (its parameters share the
    train program's names): ms, detections an image, padding rows,
    shape and label checks; DetectionMAP over the result (on synthetic
    data its value means nothing: reported, not held)."""
    cfg = S.FULL
    dmain, _, dout = S.build(fluid, cfg, train=False)
    fetch = [dout["nmsed"].name, dout["count"].name]

    def run():
        return exe.run(dmain, feed={"image": feed["image"]},
                       fetch_list=fetch, scope=scope, return_numpy=False)

    run()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with _SyncCount() as sc:
        e0.record()
        got = run()
        e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1)
    det, count = got[0].numpy(), got[1].numpy()
    b, keep = cfg["batch"], cfg["keep_top_k"]
    rows = np.arange(keep)[None, :] < count[:, None]
    labels = det[..., 0]
    if det.shape != (b, keep, 6) or not np.isfinite(det).all() \
            or (labels[~rows] != -1).any() or (labels[rows] < 1).any() \
            or (labels[rows] >= cfg["classes"]).any():
        raise AssertionError(f"decode: shape {det.shape}, counts {count}")
    gt_box = feed["gt_box"].cpu().numpy()
    gt_label = feed["gt_label"].cpu().numpy()
    dmap = fluid.metrics.DetectionMAP(overlap_threshold=0.5,
                                      ap_version="11point")
    for i in range(b):
        real = (gt_box[i, :, 2] > gt_box[i, :, 0])
        dmap.update(det[i, :count[i]], gt_box[i][real], gt_label[i][real])
    summary = dict(decode_ms=ms, detections_per_image=float(count.mean()),
                   padding_rows=int((~rows).sum()),
                   decode_syncs=sum(sc.sites().values()),
                   map_11point=float(dmap.eval()))
    log(f"mobilenet-ssd decode B={b} through detection_output "
        f"(multiclass_nms3, nms_top_k {cfg['nms_top_k']}, keep_top_k "
        f"{keep}): {ms:.3f} ms (CUDA events), "
        f"{summary['detections_per_image']:.1f} detections an image, "
        f"{summary['padding_rows']} rows of label -1, host syncs "
        f"{summary['decode_syncs']}; DetectionMAP (11point, synthetic "
        f"data: not held) {summary['map_11point']:.4f}")
    return summary


def _ssd_state_errors(gs, cs, before, trainable):
    """The card's state against the CPU's after one step from the same
    state, relative L2: the trainable parameters' updates as one vector,
    RMSProp's moments as one, and the worst other float var (with its
    name).  Integer vars must be equal."""
    upd, mom, worst = ([], []), ([], []), (0.0, "")
    for n in cs.local_var_names():
        want, got = cs.get(n), gs.get(n).cpu()
        if not want.is_floating_point():
            if not torch.equal(got, want):
                raise AssertionError(f"{n} differs")
            continue
        want, got = want.double(), got.double()
        if n in trainable:
            upd[0].append((got - before[n]).reshape(-1))
            upd[1].append((want - before[n]).reshape(-1))
        elif n.endswith(("_mean_square_0", "_momentum_0")):
            mom[0].append(got.reshape(-1))
            mom[1].append(want.reshape(-1))
        else:
            err = _rel_l2(got, want)
            if err > worst[0]:
                worst = (err, n)
    return {"update": (_rel_l2(torch.cat(upd[0]), torch.cat(upd[1])),
                       "all parameters"),
            "moment": (_rel_l2(torch.cat(mom[0]), torch.cat(mom[1])),
                       "all moments"),
            "state": worst}


def _rel_l2(got, want):
    floor = 1e-6 * max(want.numel(), 1) ** 0.5
    return float((got - want).norm()) / max(float(want.norm()), floor)


def _ssd_cut_check(fluid, S, quant=False):
    """The cut program (SMALL) on the card against the CPU Executor, each
    step from the CPU's state; the float program within SSD_LOSS_RTOL,
    SSD_UPDATE, SSD_MOMENT and SSD_STATE, the QAT one within
    QAT_LOSS_RTOL with every observer scale within QAT_SCALE.  Then (the
    float program) the cut decode program from the same state: counts
    and each image's labels equal, its scores within SSD_DET_TOL."""
    from paddle_tpu_torch.convert import load_jax_scope

    cfg = S.SMALL
    main, startup, out = S.build(fluid, cfg, quant=quant)
    gpu, cpu = fluid.Executor(), fluid.Executor(fluid.CPUPlace())
    gs, cs = fluid.Scope(), fluid.Scope()
    gpu.run(startup, scope=gs)
    cpu.run(startup, scope=cs)
    load_jax_scope(cs, {n: gs.get(n).cpu().numpy()
                        for n in gs.local_var_names()})
    feed = S.batch(cfg, seed=0)
    trainable = {p.name for p in main.all_parameters() if p.trainable}
    what = f"ssd{' qat' if quant else ''} cut"
    losses, worst = [], {}
    for i in range(SSD_CUT_STEPS):
        load_jax_scope(gs, {n: cs.get(n).numpy()
                            for n in cs.local_var_names()})
        before = {n: cs.get(n).double() for n in trainable}
        g = float(gpu.run(main, feed=feed, fetch_list=[out["loss"]],
                          scope=gs)[0])
        c = float(cpu.run(main, feed=feed, fetch_list=[out["loss"]],
                          scope=cs)[0])
        losses.append((g, c))
        rtol = QAT_LOSS_RTOL if quant else SSD_LOSS_RTOL
        if not (np.isfinite(g) and abs(g - c) <= rtol * abs(c)):
            raise AssertionError(f"{what} step {i}: card loss {g} vs CPU {c}")
        if quant:
            for n in cs.local_var_names():
                if ".quant_scale" not in n:
                    continue
                w, t = cs.get(n).double(), gs.get(n).double().cpu()
                err = float((t - w).norm()) / float(w.norm())
                if not (torch.isfinite(t).all() and (t > 0).all()
                        and err <= QAT_SCALE):
                    raise AssertionError(f"{what} step {i}: {n} {t} vs {w}")
                worst[n] = max(worst.get(n, 0.0), err)
            continue
        for kind, (err, n) in _ssd_state_errors(gs, cs, before,
                                                trainable).items():
            limit = {"update": SSD_UPDATE, "moment": SSD_MOMENT,
                     "state": SSD_STATE}[kind]
            if err > limit:
                raise AssertionError(f"{what} step {i}: {kind} {n} {err}")
            if err > worst.get(kind, (0.0, ""))[0]:
                worst[kind] = (err, n)
    if quant:
        name, err = max(worst.items(), key=lambda kv: kv[1])
        worst = {"scale": (err, name)}
    result = dict(losses=losses, worst={k: list(v) for k, v in worst.items()})
    log(f"{what} card vs CPU Executor, {SSD_CUT_STEPS} steps each from the "
        f"CPU's state: losses {[(round(a, 6), round(b, 6)) for a, b in losses]}"
        f", worst {result['worst']}")
    if quant:
        return result
    dmain, _, dout = S.build(fluid, cfg, train=False)
    load_jax_scope(gs, {n: cs.get(n).numpy() for n in cs.local_var_names()})
    fetch = [dout["nmsed"], dout["count"]]
    g = gpu.run(dmain, feed={"image": feed["image"]}, fetch_list=fetch,
                scope=gs)
    c = cpu.run(dmain, feed={"image": feed["image"]}, fetch_list=fetch,
                scope=cs)
    if not np.array_equal(g[1], c[1]):
        raise AssertionError(f"cut decode counts {g[1]} vs {c[1]}")
    for gi, ci, n in zip(g[0], c[0], c[1]):
        if sorted(gi[:n, 0]) != sorted(ci[:n, 0]):
            raise AssertionError("cut decode labels differ")
        ok, err = close(torch.from_numpy(np.sort(gi[:n, 1])),
                        torch.from_numpy(np.sort(ci[:n, 1])), **SSD_DET_TOL)
        if not ok:
            raise AssertionError(f"cut decode scores differ by {err}")
    result["decode_counts"] = c[1].tolist()
    log(f"ssd cut decode card vs CPU: counts {c[1].tolist()} and labels "
        f"equal, scores within {SSD_DET_TOL}")
    return result


def _score_ties(conf, tie):
    """Each image's candidate scores (softmax over the classes, the
    background's left out) sorted, on the CPU, and a function giving a
    row's separation: the distance from its score to the nearest other
    candidate's (the nearest one, within `tie`, being its own)."""
    scores = torch.softmax(torch.from_numpy(conf).double(), -1)[..., 1:]
    sorted_scores = [np.sort(s.reshape(-1).numpy()) for s in scores]

    def separation(image, score):
        cand = sorted_scores[image]
        at = np.searchsorted(cand, score)
        near = np.abs(cand[max(0, at - 3):at + 3] - score)
        near.sort()
        own = near[0] <= tie
        return float(near[1] if own and len(near) > 1 else near[0])
    return separation


def _ssd_head_check(fluid, S, main, exe, scope, feed, out):
    """detection_output alone on the full width's head outputs (those of
    one more train step): the card against the CPU Executor on the same
    inputs.  The two devices' softmaxes give each candidate's score a
    float32 unit or so apart (TIE: SSD_TIE_ULPS times the largest
    difference of the two devices' softmax of the same heads), so two
    candidates whose scores are within TIE may trade places at the
    keep_top_k cut or in a suppression.  Every detection whose score is
    more than TIE from every other candidate's of its image is the same
    on both (label and box, score and box within SSD_DET_TOL); a
    detection on one side only must be such a tie, else the NMS rule is
    at fault on the card.  The counts are equal."""
    heads = exe.run(main, feed=feed, fetch_list=[
        out[k] for k in ("locs", "confs", "box", "var")], scope=scope)
    hfeed = dict(zip(("loc", "conf", "box", "var"), heads))
    hmain, _, hout, hcount = S.head_program(fluid, S.FULL)
    fetch = [hout, hcount]
    g = fluid.Executor().run(hmain, feed=hfeed, fetch_list=fetch,
                             scope=fluid.Scope())
    c = fluid.Executor(fluid.CPUPlace()).run(hmain, feed=hfeed,
                                             fetch_list=fetch,
                                             scope=fluid.Scope())
    if not np.array_equal(g[1], c[1]):
        raise AssertionError(f"full-width detection_output counts {g[1]} "
                             f"vs {c[1]}")
    conf = torch.from_numpy(hfeed["conf"])
    soft_diff = float((torch.softmax(conf.cuda(), -1).cpu()
                       - torch.softmax(conf, -1)).abs().max())
    tie = SSD_TIE_ULPS * max(soft_diff, 2.0 ** -24)
    separation = _score_ties(hfeed["conf"], tie)
    got, want, rows, ties, faults = [], [], 0, [], []
    for i, (gi, ci, n) in enumerate(zip(g[0], c[0], c[1])):
        gi, ci = gi[:n], ci[:n]
        used = np.zeros(len(gi), bool)
        for r in ci:
            same = (gi[:, 0] == r[0]) & (np.abs(gi[:, 2:] - r[2:]).max(1)
                                         <= 1e-4) & ~used
            if same.any():
                j = int(np.argmax(same))
                used[j] = True
                got.append(gi[j])
                want.append(r)
            else:
                (ties if separation(i, r[1]) <= tie else faults).append(
                    ("cpu", i, r.tolist()))
        for r in gi[~used]:
            (ties if separation(i, r[1]) <= tie else faults).append(
                ("card", i, r.tolist()))
        rows += int(n)
    ok, worst = close(torch.from_numpy(np.stack(got)),
                      torch.from_numpy(np.stack(want)), **SSD_DET_TOL)
    if faults or not ok:
        raise AssertionError(
            f"full-width detection_output: {len(faults)} detections on one "
            f"side only with scores separated by more than {tie:.3g} (the "
            f"NMS rule on the card), first {faults[:3]}; matched rows within "
            f"{worst}")
    log(f"full-width detection_output (B={S.FULL['batch']}, "
        f"{S.num_priors(S.FULL)} priors) card vs CPU on the same heads: "
        f"counts equal, {len(got)} of {rows} rows the same label and box, "
        f"their scores and boxes within {worst:.3g}; {len(ties)} rows on "
        f"one side only, each a tie (its score within {tie:.3g} of another "
        f"candidate's; the softmaxes {soft_diff:.3g} apart)")
    return dict(rows=rows, agree=len(got), tie_rows=len(ties),
                tie=tie, softmax_diff=soft_diff, max_abs_err=worst)


def _det_rules_on_card(C, card="cuda"):
    """Every case of tests/torch_det_cases.py (each detection and quantize
    rule) on the card against the same rule on the CPU, float32: floats
    within DET_RULE_TOL, integers equal (the subsampling cases draw too
    few to bind: the devices' generators differ)."""
    from paddle_tpu_torch.fluid import framework as TFW
    from paddle_tpu_torch.ops import registry as R

    worst, types = (0.0, ""), set()
    for name, (op_type, ins, attrs, _) in sorted(C.CASES.items()):
        outs = {}
        for dev in ("cpu", card):
            op = TFW.Operator(TFW.Program().global_block(), 0, op_type,
                              {s: [f"{s}_{i}" for i in range(len(v))]
                               for s, v in ins.items()}, {}, dict(attrs))
            vals = {s: [torch.from_numpy(np.asarray(
                a, np.float32 if np.issubdtype(np.asarray(a).dtype,
                                               np.floating) else None))
                .to(dev) for a in v] for s, v in ins.items()}
            with torch.no_grad():
                outs[dev] = R.forward_rule(op_type)(
                    R.LowerCtx(0, device=dev), op, vals)
        for slot, want in outs["cpu"].items():
            got = outs[card][slot]
            for w, g in zip(want, got):
                if g.device.type != card:
                    raise AssertionError(f"{name} {slot} left the card")
                g = g.cpu()
                if w.is_floating_point():
                    ok, err = close(g, w, **DET_RULE_TOL)
                    if err > worst[0]:
                        worst = (err, f"{name}.{slot}")
                else:
                    ok = torch.equal(g, w)
                if not ok:
                    raise AssertionError(f"{name} {slot}: card {g} vs {w}")
        types.add(op_type)
    log(f"detection and quantize rules: {len(C.CASES)} cases of "
        f"{len(types)} op types on the card against the CPU, worst "
        f"{worst[0]:.3g} at {worst[1]} (limits {DET_RULE_TOL})")
    return dict(cases=len(C.CASES), op_types=len(types), worst=list(worst))


@phase("ssd")
def ssd():
    """PaddleCV's MobileNet-SSD on VOC at 300^2 (tests/torch_ssd_program.py
    at FULL) through fluid.Executor: trained in f32, then as
    quantization-aware training, decoded through detection_output; the
    cut program float and QAT on the card against the CPU; every
    detection and quantize rule's case on the card against the CPU."""
    from paddle_tpu_torch import fluid

    S, C = _ssd_modules()
    torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = True
    try:
        launches, summary, (exe, scope, feed, out, main) = _ssd_train(
            fluid, S)
        summary["decode"] = _ssd_decode(fluid, S, exe, scope, feed)
        summary["head_check"] = _ssd_head_check(fluid, S, main, exe, scope,
                                                feed, out)
        del exe, scope, feed, main
        torch.cuda.empty_cache()
        qat_launches, summary["qat"], _ = _ssd_train(fluid, S, quant=True)
        summary["qat"]["step_vs_float"] = (summary["qat"]["step_ms"]
                                           / summary["step_ms"])
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.benchmark = False
    _expect_launches(qat_launches, 0, (), "ssd qat steps")
    summary["cut"] = _ssd_cut_check(fluid, S)
    summary["cut_qat"] = _ssd_cut_check(fluid, S, quant=True)
    summary["rules"] = _det_rules_on_card(C)
    summary["card"] = card_line()
    log("ssd summary: " + json.dumps(summary))
    return launches


def _ctr_module():
    """tests/torch_ctr_program.py, the JAX-free program and data writer
    the parity tests hold against paddle_tpu."""
    tests = str(Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_ctr_program as C
    return C


def _ctr_state(scope):
    return {n: scope.get(n).clone() for n in scope.local_var_names()}


def _ctr_restore(scope, state):
    for n, v in state.items():
        scope.set(n, v.clone())


def _ctr_pass(exe, prog, ds, fetch, scope):
    """One train_from_dataset pass: (every step's fetch handles, the last
    fetches as numpy)."""
    handles = []
    last = exe.train_from_dataset(
        prog, ds, scope=scope, fetch_list=fetch,
        step_callback=lambda step, k, outs: handles.append(outs))
    return handles, last


def _ctr_timed(fn):
    """fn() between two CUDA events: (its result, device ms, host ms)."""
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    h0 = time.perf_counter()
    e0.record()
    out = fn()
    e1.record()
    host = (time.perf_counter() - h0) * 1e3
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1), host


def _ctr_train(fluid, C, work):
    """Write, load, warm up, then the timed pass with the counts at 0.
    Returns (launches, summary, the objects later checks use)."""
    cfg = C.FULL
    t0 = time.perf_counter()
    files = C.write_files(os.path.join(work, "train"), cfg, CTR_FILES,
                          CTR_LINES, seed=0)
    warm = C.write_files(os.path.join(work, "warm"), cfg, 1,
                         CTR_WARM_LINES, seed=500)
    held = C.write_files(os.path.join(work, "held"), cfg, 1,
                         CTR_HELD_LINES, seed=1000)
    write_s = time.perf_counter() - t0
    main, startup, out = C.build(fluid, cfg, seed=CTR_SEED)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    compiled = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=out["loss"].name)
    fetch = [out["loss"], out["auc"]]
    t0 = time.perf_counter()
    ds = C.dataset(fluid, "InMemoryDataset", out["feeds"], files, cfg,
                   threads=CTR_THREADS, seed=CTR_SEED)
    load_s = time.perf_counter() - t0
    lines = ds.get_memory_data_size()
    wds = C.dataset(fluid, "InMemoryDataset", out["feeds"], warm, cfg)
    t0 = time.perf_counter()
    _ctr_pass(exe, compiled, wds, fetch, scope)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    start = _ctr_state(scope)
    torch.cuda.reset_peak_memory_stats()
    profiler.stat_reset()
    profiler.time_reset()
    for c in COUNTERS.values():
        c.reset()
    # -- the main path: counters at 0 before, read right after --------------
    with _SyncCount() as sc:
        (handles, last), dev_ms, host_ms = _ctr_timed(
            lambda: _ctr_pass(exe, compiled, ds, fetch, scope))
    stats, times = profiler.get_int_stats(), profiler.get_time_stats()
    launches = {n: c.value for n, c in COUNTERS.items()}
    mem = torch.cuda.max_memory_allocated()
    # ------------------------------------------------------------------------
    _expect_launches(launches, 0, (), "the ctr pass")
    steps = len(handles)
    if steps != lines // cfg["batch"]:
        raise AssertionError(f"ctr pass: {steps} steps for {lines} lines")
    losses = [float(h[0]) for h in handles]
    auc = float(last[1])
    first, final = np.mean(losses[:10]), np.mean(losses[-10:])
    if not (np.isfinite(losses).all() and final < first and auc > 0.5):
        raise AssertionError(f"ctr pass: loss {first} -> {final} over the "
                             f"first and last 10 steps, auc {auc}")
    from paddle_tpu_torch.dataset import feed_pipeline
    ops = stats.get("executor_op_count", 0) / steps
    step_ms, host_step = dev_ms / steps, host_ms / steps
    sites = sc.sites()
    summary = dict(
        step_ms=step_ms, host_step_ms=host_step,
        samples_per_s=cfg["batch"] / (step_ms / 1e3), steps=steps,
        ops_per_step=ops, host_us_per_op=1e3 * host_step / ops,
        host_reads=stats.get("executor_sync_count", 0),
        syncs=sum(sites.values()), sync_sites=sites,
        ring_occupancy_max=stats.get("ring_occupancy_max", 0),
        in_flight_max=stats.get("in_flight_steps_max", 0),
        ring_empty_wait_ms=times.get("ring_empty_wait_ms", 0.0),
        ring_full_wait_ms=times.get("ring_full_wait_ms", 0.0),
        parser_wait_ms=times.get("parser_wait_ms", 0.0),
        host_feed_ms=times.get("host_feed_ms", 0.0),
        stall=feed_pipeline.attribute_stall(times),
        max_memory_allocated_bytes=mem, load_s=load_s,
        load_lines_per_s=lines / load_s, write_s=write_s, warmup_s=warm_s,
        auc=auc, loss_first10=first, loss_last10=final,
        positives=float(np.mean([np.mean(b["label"]) for b in
                                 ds.batch_iter()])))
    log(f"ctr-dnn B={cfg['batch']} through train_from_dataset"
        f"(CompiledProgram): {step_ms:.3f} ms a step (CUDA events over "
        f"{steps} steps; host clock {host_step:.3f} ms), "
        f"{summary['samples_per_s']:.0f} samples/s, {ops:.0f} ops a step at "
        f"{summary['host_us_per_op']:.1f} host us an op; host reads "
        f"{summary['host_reads']} and syncs {summary['syncs']} in the pass "
        f"({sites}); ring occupancy max {summary['ring_occupancy_max']}, "
        f"empty-wait {summary['ring_empty_wait_ms']:.1f} ms, full-wait "
        f"{summary['ring_full_wait_ms']:.1f} ms ({summary['stall']}); "
        f"max_memory_allocated {mem / 2 ** 30:.2f} GiB; loss {first:.4f} "
        f"-> {final:.4f} (first and last 10 steps), auc {auc:.4f}; "
        f"load {lines} lines in {load_s:.2f} s ({lines / load_s:.0f} "
        f"lines/s, {CTR_THREADS} threads), files written in {write_s:.1f} "
        f"s, warm-up pass {warm_s:.2f} s")
    pds = C.dataset(fluid, "InMemoryDataset", out["feeds"], warm, cfg)
    busy, wall, top = _profile(lambda: _ctr_pass(exe, compiled, pds, fetch,
                                                 scope), top=200)
    pstep = CTR_WARM_LINES // cfg["batch"]
    summary.update(
        profiled_busy_ms=busy / pstep, profiled_wall_ms=wall / pstep,
        profiled_idle=max(0.0, 1 - busy / wall),
        h2d_copies_per_step=sum(n for k, _, n in top if "HtoD" in k) / pstep,
        top_kernels=[dict(name=k[:90], ms=ms, count=n)
                     for k, ms, n in top[:12]])
    log(f"profiled pass of {pstep} steps: host-to-device copies a step "
        f"{summary['h2d_copies_per_step']:.2f}")
    return launches, summary, dict(
        exe=exe, scope=scope, main=main, out=out, compiled=compiled,
        fetch=fetch, start=start, warm=warm, held=held, cfg=cfg)


def _ctr_loaders(fluid, C, R):
    """A QueueDataset pass and an unshuffled InMemoryDataset pass over the
    warm-up file from the same weights (CTR_QUEUE_RTOL), the queue's
    samples/s; then CompiledProgram's first 3 steps against Executor.run's
    from the same weights, bit for bit (losses and every scope var)."""
    exe, scope, cfg = R["exe"], R["scope"], R["cfg"]
    feeds = R["out"]["feeds"]
    _ctr_restore(scope, R["start"])
    mem, _ = _ctr_pass(exe, R["compiled"], C.dataset(
        fluid, "InMemoryDataset", feeds, R["warm"], cfg), R["fetch"], scope)
    _ctr_restore(scope, R["start"])
    q = C.dataset(fluid, "QueueDataset", feeds, R["warm"], cfg)
    t0 = time.perf_counter()
    queue, _ = _ctr_pass(exe, R["compiled"], q, R["fetch"], scope)
    torch.cuda.synchronize()
    queue_s = time.perf_counter() - t0
    a = np.array([float(h[0]) for h in queue])
    b = np.array([float(h[0]) for h in mem])
    err = float(np.max(np.abs(a - b) / np.abs(b)))
    if len(a) != len(b) or not err <= CTR_QUEUE_RTOL:
        raise AssertionError(f"QueueDataset losses {a} vs InMemoryDataset "
                             f"{b}")
    batches = list(C.dataset(fluid, "InMemoryDataset", feeds, R["warm"],
                             cfg).batch_iter())[:3]
    runs = []
    for prog in (R["main"], R["compiled"]):
        _ctr_restore(scope, R["start"])
        losses = [exe.run(prog, feed=b, fetch_list=R["fetch"][:1],
                          scope=scope)[0] for b in batches]
        runs.append((losses, {n: scope.get(n).cpu() for n in
                              scope.local_var_names()}))
    (pl, ps), (cl, cs) = runs
    differ = [n for n in ps if not torch.equal(ps[n], cs[n])]
    if not all(np.array_equal(x, y) for x, y in zip(pl, cl)) or differ:
        raise AssertionError(f"CompiledProgram steps {cl} vs Executor.run "
                             f"{pl}; vars apart {differ[:5]}")
    log(f"QueueDataset against InMemoryDataset over {len(a)} steps from one "
        f"state: losses within {err:.3g}; the queue pass "
        f"{CTR_WARM_LINES / queue_s:.0f} samples/s; CompiledProgram's "
        f"3 steps equal Executor.run's bit for bit ({len(ps)} vars)")
    return dict(queue_vs_memory=err, queue_samples_per_s=CTR_WARM_LINES
                / queue_s, compiled_bits_equal=True)


def _ctr_nan(fluid, C, R, work):
    """FLAGS_check_nan_inf: the pass over the warm-up file with the flag
    off, on, on, off (ms a step by CUDA events); then a NaN planted in
    batch CTR_NAN_BATCH raises within prefetch_depth steps of it, naming
    a variable of the program."""
    from paddle_tpu_torch.dataset.feed_pipeline import DEFAULT_PREFETCH_DEPTH
    from paddle_tpu_torch.fluid import flags

    exe, scope, cfg = R["exe"], R["scope"], R["cfg"]
    feeds = R["out"]["feeds"]
    ms = {False: [], True: []}
    try:
        for on in (False, True, True, False):
            flags.set_flags({"FLAGS_check_nan_inf": on})
            ds = C.dataset(fluid, "InMemoryDataset", feeds, R["warm"], cfg)
            _, dev, _ = _ctr_timed(lambda: _ctr_pass(
                exe, R["compiled"], ds, R["fetch"], scope))
            ms[on].append(dev / (CTR_WARM_LINES // cfg["batch"]))
        with open(R["warm"][0]) as f:
            lines = f.readlines()
        row = CTR_NAN_BATCH * cfg["batch"] + 5
        toks = lines[row].split(" ")
        toks[1] = "nan"  # the first dense value
        lines[row] = " ".join(toks)
        bad = os.path.join(work, "nan-000")
        with open(bad, "w") as f:
            f.writelines(lines)
        flags.set_flags({"FLAGS_check_nan_inf": True})
        _ctr_restore(scope, R["start"])
        ds = C.dataset(fluid, "QueueDataset", feeds, [bad], cfg)
        done = []
        try:
            exe.train_from_dataset(
                R["compiled"], ds, scope=scope, fetch_list=R["fetch"],
                step_callback=lambda s, k, o: done.append(k))
            raise AssertionError("a planted NaN did not raise")
        except RuntimeError as e:
            msg = str(e)
    finally:
        flags.set_flags({"FLAGS_check_nan_inf": False})
    names = {v.name for v in R["main"].list_vars()}
    var = msg.split("variable ")[1].split()[0].strip("'")         if "NaN/Inf detected in variable" in msg else None
    after = len(done) - (CTR_NAN_BATCH + 1)
    if var not in names or not 0 <= after <= DEFAULT_PREFETCH_DEPTH:
        raise AssertionError(f"planted NaN at step {CTR_NAN_BATCH + 1}: "
                             f"raised after {len(done)} steps: {msg}")
    off, on = float(np.mean(ms[False])), float(np.mean(ms[True]))
    log(f"FLAGS_check_nan_inf: {on:.3f} ms a step on against {off:.3f} off "
        f"(in turns: off {ms[False]}, on {ms[True]}); the NaN planted in "
        f"step {CTR_NAN_BATCH + 1} raised {after} steps after it, naming "
        f"{var!r}")
    return dict(nan_on_ms=on, nan_off_ms=off, nan_steps_after=after,
                nan_variable=var)


def _ctr_io(fluid, C, R, work):
    """save_persistables / load_persistables into a fresh scope, bit for
    bit; save_inference_model of [predict, auc], load_inference_model
    into a fresh scope and infer_from_dataset over the held-out file
    against the trained scope's pruned forward: predictions within
    CTR_INFER_RTOL, the auc histograms equal; ms a batch."""
    exe, scope, out, cfg = R["exe"], R["scope"], R["out"], R["cfg"]
    pdir, mdir = os.path.join(work, "persist"), os.path.join(work, "model")
    with fluid.scope_guard(scope):
        fluid.io.save_persistables(exe, pdir, R["main"])
    fresh = fluid.Scope()
    with fluid.scope_guard(fresh):
        fluid.io.load_persistables(exe, pdir, R["main"])
    differ = [n for n in scope.local_var_names()
              if not torch.equal(fresh.get(n), scope.get(n).cpu())]
    if differ or len(fresh.local_var_names()) != len(
            scope.local_var_names()):
        raise AssertionError(f"persistables apart after a round trip: "
                             f"{differ[:5]}")
    names = C.feed_names()
    targets = [out["predict"], out["auc"]]
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(mdir, names, targets, exe, R["main"])
    model = fluid.Scope()
    with fluid.scope_guard(model):
        prog, feed_names, fetches = fluid.io.load_inference_model(mdir, exe)
    block = prog.global_block()
    pruned = fluid.io._prune_for_targets(R["main"], names,
                                         [t.name for t in targets])
    runs = {}
    for what, program, sc in (("loaded", prog, model),
                              ("trained", pruned, scope)):
        ds = C.dataset(fluid, "QueueDataset",
                       [block.var(n) for n in feed_names], R["held"], cfg)
        handles = []
        _, dev, _ = _ctr_timed(lambda: exe.infer_from_dataset(
            program, ds, scope=sc, fetch_list=[t.name for t in targets],
            step_callback=lambda s, k, o: handles.append(o)))
        runs[what] = ([h[0].numpy() for h in handles], dev / len(handles),
                      {n: sc.get(n).cpu() for n in (out["stat_pos"].name,
                                                    out["stat_neg"].name)})
    (lp, lms, lh), (tp, _, th) = runs["loaded"], runs["trained"]
    err = max(float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
              for a, b in zip(lp, tp))
    hist_equal = all(torch.equal(lh[n], th[n]) for n in lh)
    if len(lp) != CTR_HELD_LINES // cfg["batch"] or not err <= \
            CTR_INFER_RTOL or not hist_equal:
        raise AssertionError(f"inference: {len(lp)} batches, predictions "
                             f"within {err}, histograms equal {hist_equal}")
    log(f"save/load_persistables: {len(differ) == 0} bit for bit over "
        f"{len(scope.local_var_names())} vars; the inference model "
        f"({len(block.ops)} ops) loaded in a fresh scope over {len(lp)} "
        f"held-out batches: {lms:.3f} ms a batch, predictions within "
        f"{err:.3g} of the trained scope's, auc histograms equal")
    return dict(persist_bits_equal=True, infer_ms_per_batch=lms,
                infer_rel_err=err, infer_ops=len(block.ops))


def _ctr_card_vs_cpu(fluid, C, work):
    """SMALL trained by train_from_dataset on the card and on the CPU
    Executor from the same weights over the same shuffled files: each
    loss within CTR_LOSS_RTOL, the updates and Adam's moments within
    CTR_UPDATE, the auc histograms equal."""
    cfg = C.SMALL
    files = C.write_files(os.path.join(work, "small"), cfg, 3, 40)
    main, startup, out = C.build(fluid, cfg)
    gpu, cpu = fluid.Executor(), fluid.Executor(fluid.CPUPlace())
    gs, cs = fluid.Scope(), fluid.Scope()
    cpu.run(startup, scope=cs)
    for n in cs.local_var_names():
        gs.set(n, cs.get(n).cuda())
    before = {n: cs.get(n).double() for n in cs.local_var_names()}
    losses = []
    for exe, sc in ((gpu, gs), (cpu, cs)):
        ds = C.dataset(fluid, "InMemoryDataset", out["feeds"], files, cfg,
                       threads=2, seed=CTR_SEED)
        handles, _ = _ctr_pass(exe, main, ds, [out["loss"]], sc)
        losses.append(np.array([float(h[0]) for h in handles]))
    params = [p.name for p in main.all_parameters()]
    moments = sorted(n for n in cs.local_var_names() if "moment" in n)

    def vec(scope, names, minus=None):
        return torch.cat([(scope.get(n).double().cpu()
                           - (minus[n] if minus else 0)).reshape(-1)
                          for n in names])

    upd = _rel_l2(vec(gs, params, before), vec(cs, params, before))
    mom = _rel_l2(vec(gs, moments), vec(cs, moments))
    loss_err = float(np.max(np.abs(losses[0] - losses[1])
                            / np.abs(losses[1])))
    hist = [out["stat_pos"].name, out["stat_neg"].name]
    hist_equal = all(torch.equal(gs.get(n).cpu(), cs.get(n)) for n in hist)
    if not (loss_err <= CTR_LOSS_RTOL and upd <= CTR_UPDATE
            and mom <= CTR_UPDATE and hist_equal):
        raise AssertionError(f"ctr SMALL card vs CPU: losses {loss_err}, "
                             f"updates {upd}, moments {mom}, histograms "
                             f"equal {hist_equal}")
    log(f"ctr SMALL card vs CPU over {len(losses[0])} steps: losses within "
        f"{loss_err:.3g}, updates {upd:.3g}, Adam moments {mom:.3g} "
        f"(relative L2), auc histograms equal")
    return dict(loss=loss_err, update=upd, moment=mom)


@phase("ctr")
def ctr():
    """PaddleRec's CTR-DNN on Criteo-format files (tests/torch_ctr_program.py
    at FULL) through the dataset path: see the module's docstring."""
    from paddle_tpu_torch import fluid

    C = _ctr_module()
    work = tempfile.mkdtemp(prefix="ctr_")
    try:
        launches, summary, R = _ctr_train(fluid, C, work)
        summary.update(_ctr_io(fluid, C, R, work))
        summary.update(_ctr_loaders(fluid, C, R))
        summary.update(_ctr_nan(fluid, C, R, work))
        del R
        torch.cuda.empty_cache()
        summary["card_vs_cpu"] = _ctr_card_vs_cpu(fluid, C, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    summary["card"] = card_line()
    log("ctr summary: " + json.dumps(summary))
    return launches


# the deploy phase.  (a) CTR-DNN at FULL (tests/torch_ctr_program.py)
# through train_from_dataset(CompiledProgram) with auto-checkpoints every
# DEPLOY_EVERY steps, over DEPLOY_FILES files of DEPLOY_LINES synthetic
# lines (12 steps at B=1000: the files are cut, not the widths),
# preempted by an exception from step_callback after step DEPLOY_PREEMPT
# of the epoch and resumed in a fresh Executor and Scope
DEPLOY_FILES, DEPLOY_LINES, DEPLOY_EVERY, DEPLOY_PREEMPT = 2, 6000, 4, 6
# the card's embedding and index_add backward sum with atomics, in no
# fixed order, so a resumed run is held to the uninterrupted one's losses
# within DEPLOY_RESUME_RTOL, and its parameters' updates and Adam's
# moments, as one vector each, within CTR_UPDATE (relative L2)
DEPLOY_RESUME_RTOL = 1e-5
# (b) BERT-base in bf16, eval, exported at (DEPLOY_BATCH, SEQ); each
# Predictor's outputs against the eager BertModel's: SERVE_MAX_ABS and
# SERVE_MEAN_ABS (the same kernels on the same inputs measured 0)
DEPLOY_BATCH = 32
DEPLOY_BERT = dict(cfg=bert.BertConfig.base, layers=LAYERS)
# (c) one ModelRegistry: "bert" (the default-arm Predictor) and "ctr" (a
# ProgramModel over the CTR inference program); DEPLOY_BERT_REQS requests
# of 1-16 rows and DEPLOY_CTR_REQS of DEPLOY_CTR_ROWS rows from two
# client threads each; quotas and priorities per tenant
DEPLOY_BERT_REQS, DEPLOY_CTR_REQS = 24, 48
DEPLOY_CTR_ROWS = (16, 33)
DEPLOY_BERT_QUOTA, DEPLOY_CTR_QUOTA = 32, 8
# a CTR response against the inference program run directly on the card
# on the weights its batch resolved, float32 products blocked for another
# batch shape
DEPLOY_CTR_TOL = dict(rtol=1e-5, atol=1e-6)
# (d) tests/torch_ckpt_worker.py on the card at a cut width (the table
# cut to 100003 rows, B=256; the fc widths are FULL's), two files of
# DEPLOY_KILL_LINES lines: 8 steps, checkpoints every 2
DEPLOY_KILL_CFG = dict(hash_dim=100003, width=400, batch=256)
DEPLOY_KILL_LINES = 1024


class _Preempted(Exception):
    """Raised from step_callback: a preemption inside the process."""


def _deploy_pass(fluid, C, cfg, prog, out, files, start, ckpt=None,
                 preempt_at=None, fresh_startup=None, every=None):
    """One pass of a fresh 'process': a new Executor and Scope (holding
    `start`, or the startup program's random values when `fresh_startup`
    is given: a resume must overwrite them), a new dataset over `files`,
    `prog` through train_from_dataset, auto-checkpointing into `ckpt`
    every `every` steps (DEPLOY_EVERY), stopped by an exception from
    step_callback after step `preempt_at` of the epoch.  Returns (losses
    by step in the epoch, the scope, times): `times["step_ms"]` is the
    host's mean interval between two steps' callbacks (the loop runs at
    most prefetch_depth steps ahead of the card), `times["end_ms"]` the
    host time from the last callback to the return (the end-of-pass
    checkpoint's write, waited for), `times["pass_ms"]` the pass by CUDA
    events."""
    exe, scope = fluid.Executor(), fluid.Scope()
    if fresh_startup is not None:
        exe.run(fresh_startup, scope=scope)
    else:
        _ctr_restore(scope, start)
    ds = C.dataset(fluid, "InMemoryDataset", out["feeds"], files, cfg,
                   threads=CTR_THREADS, seed=CTR_SEED)
    handles, stamps = {}, []

    def cb(step, k, outs):
        handles[k] = outs[0]
        stamps.append(time.perf_counter())
        if k == preempt_at:
            raise _Preempted(k)

    def run():
        try:
            exe.train_from_dataset(
                prog, ds, scope=scope, fetch_list=[out["loss"]],
                checkpoint_dir=ckpt,
                checkpoint_every_steps=(every or DEPLOY_EVERY) if ckpt
                else None,
                step_callback=cb)
        except _Preempted:
            pass
        return time.perf_counter()

    end, pass_ms, _ = _ctr_timed(run)
    times = dict(pass_ms=pass_ms, end_ms=(end - stamps[-1]) * 1e3,
                 step_ms=(stamps[-1] - stamps[0]) * 1e3 / max(
                     len(stamps) - 1, 1))
    return {k: float(h) for k, h in handles.items()}, scope, times


def _loss_err(got, want):
    return max(abs(got[k] - want[k]) / abs(want[k]) for k in got)


def _rel_vec(scope, ref, start, names, update=True):
    def vec(s):
        return torch.cat([(s.get(n).double().cpu() - (
            start[n].double().cpu() if update else 0)).reshape(-1)
            for n in names])
    return _rel_l2(vec(scope), vec(ref))


def _deploy_ckpt(fluid, C, work):
    """(a): the uninterrupted pass with and without checkpoints from one
    state (turns: without, with, without), the preempted pass and its
    resume; returns the summary and what (c) serves."""
    cfg = C.FULL
    files = C.write_files(os.path.join(work, "train"), cfg, DEPLOY_FILES,
                          DEPLOY_LINES, seed=0)
    warm = C.write_files(os.path.join(work, "warm"), cfg, 1, 2 * cfg[
        "batch"], seed=500)
    main, startup, out = C.build(fluid, cfg, seed=CTR_SEED)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    fresh = _ctr_state(scope)  # the untrained weights (c) starts from
    compiled = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=out["loss"].name)
    # the warm-up pass checkpoints each of its 2 steps: the first two
    # snapshots' pinned buffers come from cudaHostAlloc, later ones from
    # the caching host allocator
    profiler.stat_reset()
    profiler.time_reset()
    _deploy_pass(fluid, C, cfg, compiled, out, warm, fresh,
                 ckpt=os.path.join(work, "warm_ckpt"), every=1)
    cold_ms = profiler.get_time_stats().get("ckpt_stall_ms", 0.0) / max(
        profiler.get_int_stats().get("ckpt_snapshots_total", 0), 1)
    start = fresh
    steps = DEPLOY_FILES * DEPLOY_LINES // cfg["batch"]
    root = os.path.join(work, "ckpt")
    profiler.stat_reset()
    profiler.time_reset()
    plain, _, plain_t = _deploy_pass(fluid, C, cfg, compiled, out, files,
                                     start)
    whole, wscope, ck_t = _deploy_pass(fluid, C, cfg, compiled, out, files,
                                       start, ckpt=root)
    stats, times = profiler.get_int_stats(), profiler.get_time_stats()
    plain2, _, plain2_t = _deploy_pass(fluid, C, cfg, compiled, out, files,
                                       start)
    if sorted(whole) != list(range(1, steps + 1)) or sorted(plain) != \
            sorted(whole) or max(_loss_err(plain, whole),
                                 _loss_err(plain2, whole)) > \
            DEPLOY_RESUME_RTOL:
        raise AssertionError(f"checkpointing moved the losses: {whole} "
                             f"against {plain} / {plain2}")
    saves = stats.get("ckpt_saves_total", 0)
    snaps = stats.get("ckpt_snapshots_total", 0)
    newest = latest_checkpoint(root)
    manifest = json.loads(Path(newest, "manifest.json").read_text())
    commit_bytes = sum(int(np.prod(v["shape"])) * np.dtype(
        "int16" if v["dtype"] == "bfloat16" else v["dtype"]).itemsize
        for v in manifest["vars"].values())
    file_bytes = os.path.getsize(os.path.join(newest, "shard_00000.npz"))
    if saves != steps // DEPLOY_EVERY or snaps != saves or \
            manifest["meta"]["step_in_epoch"] != steps:
        raise AssertionError(f"{saves} commits and {snaps} snapshots for "
                             f"{steps} steps at every {DEPLOY_EVERY}; "
                             f"meta {manifest['meta']}")
    # the preempted pass and its resume in a fresh Executor and Scope
    cut_root = os.path.join(work, "cut")
    part, _, _ = _deploy_pass(fluid, C, cfg, compiled, out, files, start,
                              ckpt=cut_root, preempt_at=DEPLOY_PREEMPT)
    rest, rscope, _ = _deploy_pass(fluid, C, cfg, compiled, out, files,
                                   start, ckpt=cut_root,
                                   fresh_startup=startup)
    resumed_at = DEPLOY_PREEMPT - DEPLOY_PREEMPT % DEPLOY_EVERY
    if sorted(part) != list(range(1, DEPLOY_PREEMPT + 1)) or \
            sorted(rest) != list(range(resumed_at + 1, steps + 1)):
        raise AssertionError(f"preempted steps {sorted(part)}, resumed "
                             f"steps {sorted(rest)}")
    loss_err = _loss_err(rest, whole)
    params = [p.name for p in main.all_parameters()]
    moments = sorted(n for n in wscope.local_var_names() if "moment" in n)
    upd = _rel_vec(rscope, wscope, start, params)
    mom = _rel_vec(rscope, wscope, start, moments, update=False)
    bits = all(torch.equal(rscope.get(n), wscope.get(n))
               for n in wscope.local_var_names())
    if not (loss_err <= DEPLOY_RESUME_RTOL and upd <= CTR_UPDATE
            and mom <= CTR_UPDATE):
        raise AssertionError(f"resumed: losses within {loss_err}, updates "
                             f"{upd}, moments {mom}")
    step_plain = (plain_t["step_ms"] + plain2_t["step_ms"]) / 2
    summary = dict(
        steps=steps, every=DEPLOY_EVERY,
        step_ms_plain=[plain_t["step_ms"], plain2_t["step_ms"]],
        step_ms_ckpt=ck_t["step_ms"],
        pass_ms_plain=[plain_t["pass_ms"], plain2_t["pass_ms"]],
        pass_ms_ckpt=ck_t["pass_ms"], end_of_pass_ms_ckpt=ck_t["end_ms"],
        end_of_pass_ms_plain=[plain_t["end_ms"], plain2_t["end_ms"]],
        commits=saves, commit_bytes=commit_bytes, file_bytes=file_bytes,
        cold_snapshot_host_ms=cold_ms,
        commit_ms=times.get("ckpt_save_ms", 0.0) / max(saves, 1),
        snapshot_host_ms=times.get("ckpt_stall_ms", 0.0) / max(snaps, 1),
        snapshot_copy_ms=times.get("ckpt_copy_ms", 0.0) / max(snaps, 1),
        resumed_at=resumed_at, resume_loss_err=loss_err,
        resume_update=upd, resume_moment=mom, resume_bits_equal=bits)
    summary["snapshot_share_of_a_step"] = (
        summary["snapshot_host_ms"] + summary["snapshot_copy_ms"]) / (
        DEPLOY_EVERY * step_plain)
    log(f"ctr-dnn B={cfg['batch']}, {steps} steps: {step_plain:.3f} ms a "
        f"step without checkpoints ({plain_t['step_ms']:.3f}, "
        f"{plain2_t['step_ms']:.3f} in turns; host clock between steps), "
        f"{ck_t['step_ms']:.3f} with one every {DEPLOY_EVERY}; the pass "
        f"{ck_t['pass_ms']:.1f} ms by CUDA events against "
        f"{plain_t['pass_ms']:.1f} / {plain2_t['pass_ms']:.1f}, of which "
        f"{ck_t['end_ms']:.1f} ms after the last step (the end-of-pass "
        f"commit waited for) against {plain_t['end_ms']:.1f} / "
        f"{plain2_t['end_ms']:.1f}; {saves} commits of "
        f"{commit_bytes / 2 ** 20:.1f} MiB ({file_bytes / 2 ** 20:.1f} MiB "
        f"on disk) at {summary['commit_ms']:.1f} ms each on the writer "
        f"thread; a snapshot {summary['snapshot_host_ms']:.3f} ms of host "
        f"enqueue and {summary['snapshot_copy_ms']:.3f} ms of device copy, "
        f"{100 * summary['snapshot_share_of_a_step']:.2f} % of the steps "
        f"between two (a cold snapshot, allocating its pinned buffers: "
        f"{cold_ms:.3f} ms of host); the losses with and without within "
        f"{max(_loss_err(plain, whole), _loss_err(plain2, whole)):.3g}")
    log(f"preempted after step {DEPLOY_PREEMPT}, resumed in a fresh "
        f"Executor and Scope from step {resumed_at}: losses within "
        f"{loss_err:.3g}, updates {upd:.3g}, moments {mom:.3g} (relative "
        f"L2); bit for bit: {bits}")
    return summary, dict(main=main, out=out, fresh=fresh, trained=wscope,
                         root=root, cfg=cfg, exe=exe)


class _BertServe(pnn.Layer):
    """BertModel's (encoded, pooled) over (ids, types, padding mask), the
    form serve_slice serves."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, ids, types, mask):
        return self.model(ids, types,
                          attention_mask=(mask != 0)[:, None, None, :])


def _graph_ops(pred):
    return [str(n.target) for n in pred._exported.graph.nodes
            if n.op == "call_function"
            and str(n.target).startswith("paddle_tpu_torch.")]


def _deploy_export(work):
    """(b): BERT-base exported under the default FFN arm and under
    enable_fused_ffn, each loaded and run once on an export-sized batch
    with the counts at 0: its operators in the graph, its launches, its
    outputs against the eager model's.  Returns (the default-arm
    Predictor, the eager layer, launches of both runs, summary)."""
    from paddle_tpu_torch import inference

    cfg = DEPLOY_BERT["cfg"]()
    model = bert.BertModel(cfg, dtype=torch.bfloat16, seed=0).eval()
    layer = _BertServe(model)
    reqs = _request_batches(cfg, 4, seed=11)
    batch = [np.concatenate(cols)[:DEPLOY_BATCH] for cols in zip(*reqs)]
    batch = [np.concatenate([b] * (-(-DEPLOY_BATCH // len(b))))[
        :DEPLOY_BATCH] for b in batch]
    summary, launches, preds = {}, {}, {}
    want_ops = {"default": {"flash_forward": DEPLOY_BERT["layers"],
                            "ffn_act_fwd": DEPLOY_BERT["layers"]},
                "fused": {"flash_forward": DEPLOY_BERT["layers"],
                          "ffn_forward": DEPLOY_BERT["layers"]}}
    want_launch = {"default": ("flash_fwd", "ffn_act_fwd"),
                   "fused": ("flash_fwd", "ffn_fwd")}
    for arm in ("default", "fused"):
        F._FFN_DISABLED = None if arm == "fused" else _FFN_DEFAULT
        try:
            t0 = time.perf_counter()
            prefix = inference.save_inference_model(
                os.path.join(work, f"bert_{arm}"), layer, batch)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            pred = inference.load_inference_model(prefix)
            load_s = time.perf_counter() - t0
            ops = _graph_ops(pred)
            counted = {o.split(".")[1]: ops.count(o) for o in set(ops)}
            if counted != want_ops[arm]:
                raise AssertionError(f"{arm} arm: the graph holds {counted},"
                                     f" want {want_ops[arm]}")
            pred.run(batch)  # warm-up
            torch.cuda.synchronize()
            for c in COUNTERS.values():
                c.reset()
            # -- the main path: counters at 0 before, read right after --
            got = pred.run(batch)
            launches[arm] = {n: c.value for n, c in COUNTERS.items()}
            # -----------------------------------------------------------------
            for n, v in launches[arm].items():
                want = DEPLOY_BERT["layers"] if n in want_launch[arm] else 0
                if v != want:
                    raise AssertionError(f"{arm} Predictor.run: {n} launched "
                                         f"{v} times, want {want}")
            with torch.inference_mode():
                eager = layer(*[torch.from_numpy(b).cuda() for b in batch])
            err = [np.abs(g - e.float().cpu().numpy()) for g, e in
                   zip(got, eager)]
            worst_max = max(float(e.max()) for e in err)
            worst_mean = max(float(e.mean()) for e in err)
            if worst_max > SERVE_MAX_ABS or worst_mean > SERVE_MEAN_ABS or \
                    not all(np.isfinite(g).all() for g in got):
                raise AssertionError(f"{arm} Predictor vs eager: max abs "
                                     f"{worst_max}, mean {worst_mean}")
            xs = [torch.from_numpy(b).cuda() for b in batch]
            with torch.inference_mode():
                eager_ms = time_ms(lambda: layer(*xs), iters=5, warmup=1)
            run_ms = time_ms(lambda: pred.run_handles(batch), iters=5,
                             warmup=1)
            summary[arm] = dict(graph_ops=counted, launches={
                n: v for n, v in launches[arm].items() if v},
                export_s=export_s, load_s=load_s, max_abs=worst_max,
                mean_abs=worst_mean, run_ms=run_ms, eager_ms=eager_ms,
                pt2_bytes=os.path.getsize(prefix + ".pt2"))
            preds[arm] = pred
            log(f"BERT-base bf16 exported under the {arm} FFN arm in "
                f"{export_s:.1f} s ({summary[arm]['pt2_bytes'] / 2 ** 20:.0f}"
                f" MiB .pt2), loaded in {load_s:.1f} s: graph operators "
                f"{counted}; Predictor.run of {DEPLOY_BATCH} x {SEQ} "
                f"launched {summary[arm]['launches']}; against the eager "
                f"model max abs {worst_max:.4g}, worst mean abs "
                f"{worst_mean:.4g}; run_handles {run_ms:.3f} ms, eager "
                f"forward {eager_ms:.3f} ms (CUDA events, the feed's copy "
                f"in the first)")
        finally:
            F.enable_fused_ffn()  # main()'s arm for the other phases
    return preds["default"], layer, launches, summary


def _ctr_requests(C, cfg, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rows = int(rng.integers(*DEPLOY_CTR_ROWS))
        dense, ids, _ = C.rows(cfg, rows, seed * 1000 + i)
        out.append([dense.astype(np.float32)] + [ids[:, j:j + 1]
                                                  for j in range(C.SLOTS)])
    return out


def _deploy_serve(fluid, C, work, pred, layer, trained):
    """(c): one ModelRegistry serving "bert" and "ctr" to client threads,
    a mid-traffic reload of "ctr" from (a)'s checkpoint root, then a quota
    overrun and an unregister under bert traffic."""
    from paddle_tpu_torch.serving import (EngineOverloaded, ModelRegistry,
                                          ProgramModel, RequestCancelled)

    cfg, main, out = trained["cfg"], trained["main"], trained["out"]
    names = C.feed_names()[:-1]  # the label is not a prediction's input
    mdir = os.path.join(work, "ctr_model")
    old_scope = fluid.Scope()
    _ctr_restore(old_scope, trained["fresh"])
    exe = fluid.Executor()
    with fluid.scope_guard(old_scope):
        fluid.io.save_inference_model(mdir, names, [out["predict"]], exe,
                                      main)
    served = fluid.Scope()
    with fluid.scope_guard(served):
        prog, feeds, fetches = fluid.io.load_inference_model(mdir, exe)
    new_scope = fluid.Scope()
    for n in served.local_var_names():
        new_scope.set(n, trained["trained"].get(n).clone())
    ctr_model = ProgramModel(exe, prog, feeds, fetches, scope=served,
                             buckets=[DEPLOY_CTR_ROWS[1] - 1])
    bcfg = DEPLOY_BERT["cfg"]()
    reg = ModelRegistry(EngineConfig(max_batch_size=DEPLOY_BATCH,
                                     max_queue_delay_ms=5.0, max_queue=128,
                                     max_in_flight=2))
    bert_calls = [0]
    wrapped = reg.register("bert", pred, quota=DEPLOY_BERT_QUOTA,
                           priority=1.0)
    runner_call = wrapped.runner._call

    def counted(padded):  # one model call (warm-ups and chunks too)
        bert_calls[0] += 1
        return runner_call(padded)

    wrapped.runner._call = counted
    reg.register("ctr", ctr_model, quota=DEPLOY_CTR_QUOTA, priority=0.0)
    breqs = _request_batches(bcfg, DEPLOY_BERT_REQS, seed=13)
    creqs = _ctr_requests(C, cfg, DEPLOY_CTR_REQS, seed=17)
    reg.infer("bert", breqs[0], timeout=300)  # warm both tenants
    reg.infer("ctr", creqs[0], timeout=300)
    profiler.stat_reset()
    profiler.time_reset()
    reset_latency()
    bert_calls[0] = 0
    for c in COUNTERS.values():
        c.reset()
    cresp, csub = [None] * len(creqs), [0.0] * len(creqs)
    bsent, bdone, reload_at = [], {}, {}
    stop = threading.Event()

    def bclient(lo):
        # bert traffic until the reload is over and a little after
        i = lo
        while not stop.is_set():
            try:
                bsent.append((i % len(breqs),
                              reg.submit("bert", breqs[i % len(breqs)])))
                i += 2
            except EngineOverloaded:
                pass  # its quota: wait and resubmit
            time.sleep(0.05)

    def cclient(lo):
        for i in range(lo, len(creqs), 2):
            while True:
                try:
                    csub[i] = time.perf_counter()
                    cresp[i] = reg.submit("ctr", creqs[i])
                    break
                except EngineOverloaded:
                    time.sleep(0.002)  # its quota: wait and resubmit
            time.sleep(0.1)

    def stamp():
        # when each bert response is done (polled each ms)
        while not (stop.is_set() and len(bdone) == len(bsent)):
            now = time.perf_counter()
            for _, r in list(bsent):
                if id(r) not in bdone and r.done():
                    bdone[id(r)] = now
            time.sleep(0.001)

    # -- the main path: counters at 0 before, read right after -------------
    t0 = time.perf_counter()
    threads = [threading.Thread(target=f, args=(lo,)) for f in
               (bclient, cclient) for lo in range(2)]
    threads.append(threading.Thread(target=stamp))
    for th in threads:
        th.start()
    while sum(r is not None and r.done() for r in cresp) < \
            DEPLOY_CTR_REQS // 3:
        time.sleep(0.002)
    reload_at["t0"] = time.perf_counter()
    swapped = reg.reload_weights("ctr", trained["root"])
    reload_at["t1"] = time.perf_counter()
    for th in threads[2:4]:
        th.join()
    time.sleep(0.2)
    stop.set()
    for th in threads:
        th.join()
    bout = [(i, r.result(timeout=300)) for i, r in bsent]
    couts = [r.result(timeout=300) for r in cresp]
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {n: c.value for n, c in COUNTERS.items()}
    stats = {t: reg.stats(t) for t in ("bert", "ctr")}
    # ------------------------------------------------------------------------
    calls = bert_calls[0]
    for n, v in launches.items():
        want = DEPLOY_BERT["layers"] * calls if n in ("flash_fwd",
                                                      "ffn_act_fwd") else 0
        if v != want or (want == 0 and n in ("flash_fwd", "ffn_act_fwd")):
            raise AssertionError(f"bert tenant: {n} launched {v} times over "
                                 f"{calls} model calls (want {want})")
    # bert: every response finite and equal to the eager forward (8 held)
    worst = 0.0
    with torch.inference_mode():
        for i, (enc, pooled) in bout[:8]:
            e, p = layer(*[torch.from_numpy(a).cuda() for a in breqs[i]])
            for got, want in ((enc, e), (pooled, p)):
                worst = max(worst, float(np.abs(
                    got - want.float().cpu().numpy()).max()))
    if worst > SERVE_MAX_ABS or not all(
            np.isfinite(o).all() for _, resp in bout for o in resp):
        raise AssertionError(f"bert responses: max abs {worst}")
    # bert never paused: its responses kept coming during the reload
    # (one at least, where the reload outlasts the longest wait between
    # two bert responses elsewhere); the waits across it are printed
    times = sorted(bdone.values())
    during = [t for t in times if reload_at["t0"] <= t <= reload_at["t1"]]
    spans = list(zip(times, times[1:]))
    gap_in = max([b - a for a, b in spans if b >= reload_at["t0"]
                  and a <= reload_at["t1"]] or [0.0])
    gap_out = max([b - a for a, b in spans if b < reload_at["t0"]
                   or a > reload_at["t1"]] or [0.0])
    if not during and reload_at["t1"] - reload_at["t0"] > gap_out:
        raise AssertionError(f"no bert response during the reload's "
                             f"{(reload_at['t1'] - reload_at['t0']) * 1e3:.1f}"
                             f" ms (the longest wait elsewhere "
                             f"{gap_out * 1e3:.1f} ms)")
    # ctr: before the reload the old weights' forward, submitted after it
    # the new weights', in between either
    kinds = {"old": 0, "new": 0}
    sep = float("inf")
    for req, (pred_out,), sub in zip(creqs, couts, csub):
        want = {}
        for kind, sc in (("old", old_scope), ("new", new_scope)):
            want[kind] = exe.run(prog, feed=dict(zip(feeds, req)),
                                 fetch_list=fetches, scope=sc)[0]
        sep = min(sep, float(np.abs(want["old"] - want["new"]).max()))
        match = [k for k in ("old", "new")
                 if np.allclose(pred_out, want[k], **DEPLOY_CTR_TOL)]
        must = "new" if sub > reload_at["t1"] else None
        if not match or (must and must not in match):
            raise AssertionError(f"ctr response submitted at {sub - t0:.3f}"
                                 f" s (reload {reload_at['t0'] - t0:.3f}-"
                                 f"{reload_at['t1'] - t0:.3f} s) matches "
                                 f"{match}")
        kinds[match[-1]] += 1
    if kinds["new"] == 0 or kinds["old"] == 0:
        raise AssertionError(f"ctr responses by weights: {kinds}")
    summary = dict(
        wall_s=wall, swapped_vars=swapped,
        reload_ms=(reload_at["t1"] - reload_at["t0"]) * 1e3,
        ctr_by_weights=kinds, old_new_min_separation=sep,
        bert_requests=len(bsent), bert_done_during_reload=len(during),
        bert_longest_gap_across_reload_ms=gap_in * 1e3,
        bert_longest_gap_elsewhere_ms=gap_out * 1e3,
        bert_calls=calls, bert_launches_per_batch={
            n: v / calls for n, v in launches.items() if v},
        tenants={t: dict(completed=s["completed_total"],
                         rejected=s["rejected_total"],
                         p50_ms=s.get("latency", {}).get("p50_ms"),
                         p99_ms=s.get("latency", {}).get("p99_ms"))
                 for t, s in stats.items()},
        bert_max_abs=worst)
    log(f"two tenants over {wall:.2f} s: bert {stats['bert']['latency']}, "
        f"ctr {stats['ctr']['latency']}; completed "
        f"{ {t: s['completed_total'] for t, s in stats.items()} }, "
        f"rejected (a client resubmits) "
        f"{ {t: s['rejected_total'] for t, s in stats.items()} }; "
        f"bert launches a batch {summary['bert_launches_per_batch']} over "
        f"{calls} batches; reload of {swapped} vars in "
        f"{summary['reload_ms']:.1f} ms mid-traffic, {len(during)} bert "
        f"responses inside it (the longest wait between two bert "
        f"responses {gap_in * 1e3:.1f} ms across it, "
        f"{gap_out * 1e3:.1f} ms elsewhere), "
        f"ctr responses on the "
        f"old / new weights {kinds} (the two forwards at least {sep:.3g} "
        f"apart), bert responses max abs {worst:.4g} from the eager model")
    # a quota overrun: ctr's burst is refused for ctr alone
    burst, rejected = [], []
    for req in creqs[:4 * DEPLOY_CTR_QUOTA]:
        try:
            burst.append(reg.submit("ctr", req))
        except EngineOverloaded as e:
            rejected.append(e.resource)
    others = [reg.submit("bert", breqs[i]) for i in range(4)]
    for r in burst + others:
        r.result(timeout=300)
    if not rejected or set(rejected) != {"tenant:ctr"}:
        raise AssertionError(f"quota overrun: rejected {rejected}")
    # unregister: ctr's queued requests cancelled, bert's answered
    bq = [reg.submit("bert", breqs[i], priority=5.0) for i in range(8)]
    cq = [reg.submit("ctr", req) for req in creqs[:DEPLOY_CTR_QUOTA]]
    reg.unregister("ctr")
    cancelled = answered = 0
    for r in cq:
        try:
            r.result(timeout=300)
            answered += 1
        except RequestCancelled:
            cancelled += 1
    for r in bq:
        r.result(timeout=300)
    if cancelled == 0 or reg.model_names() != ["bert"]:
        raise AssertionError(f"unregister: {cancelled} cancelled, "
                             f"{answered} answered, {reg.model_names()}")
    reg.close()
    summary.update(quota_rejections=len(rejected),
                   quota_admitted=len(burst), unregister_cancelled=cancelled,
                   unregister_answered=answered)
    log(f"quota {DEPLOY_CTR_QUOTA}: a burst of {4 * DEPLOY_CTR_QUOTA} ctr "
        f"requests, {len(rejected)} refused (tenant:ctr only), 4 bert "
        f"requests admitted beside it; unregister('ctr') cancelled "
        f"{cancelled} queued requests ({answered} were in flight), 8 bert "
        f"requests answered")
    return launches, summary


def _deploy_sigkill(C, work, device="cuda"):
    """(d): tests/torch_ckpt_worker.py on the card at DEPLOY_KILL_CFG, the
    golden and the killed worker at once, then the resumed one."""
    cfg = dict(C.SMALL, **DEPLOY_KILL_CFG)
    data = os.path.join(work, "kill_data")
    C.write_files(data, cfg, 2, DEPLOY_KILL_LINES, seed=40)
    worker = str(Path(__file__).resolve().parent / "tests"
                 / "torch_ckpt_worker.py")

    def start(out, ck, kill_at=-1):
        env = dict(os.environ, DATA_DIR=data, DEVICE=device,
                   CTR_CFG=json.dumps(DEPLOY_KILL_CFG),
                   PYTHONPATH=str(Path(__file__).resolve().parent),
                   PADDLE_CKPT_DIR=ck, PADDLE_CKPT_EVERY_STEPS="2",
                   KILL_AT_STEP=str(kill_at))
        return subprocess.Popen([sys.executable, worker, out], env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    def finish(p):
        try:
            out, err = p.communicate(timeout=300)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        return p.returncode, out + err

    gold, log_ = os.path.join(work, "gold.txt"), os.path.join(work, "t.txt")
    steps = 2 * DEPLOY_KILL_LINES // cfg["batch"]
    kill_at = 1 + steps // 2  # the executor's step: startup is step 1
    t0 = time.perf_counter()
    pg = start(gold, os.path.join(work, "ck_gold"))
    pk = start(log_, os.path.join(work, "ck_kill"), kill_at)
    (rg, og), (rk, ok) = finish(pg), finish(pk)
    if rg != 0 or rk != -9:
        raise AssertionError(f"golden worker rc {rg}, killed worker rc "
                             f"{rk}:\n{og[-2000:]}\n{ok[-2000:]}")
    rr, orr = finish(start(log_, os.path.join(work, "ck_kill")))
    wall = time.perf_counter() - t0
    if rr != 0:
        raise AssertionError(f"resumed worker rc {rr}:\n{orr[-2000:]}")

    def traj(path):
        out = {}
        for line in Path(path).read_text().splitlines():
            s, loss = line.split()
            out[int(s)] = float(loss)
        return out

    want, got = traj(gold), traj(log_)
    err = max(abs(got[s] - want[s]) / abs(want[s]) for s in want)
    if sorted(got) != sorted(want) or len(want) != steps or \
            err > DEPLOY_RESUME_RTOL:
        raise AssertionError(f"SIGKILL resume: steps {sorted(got)} vs "
                             f"{sorted(want)}, losses within {err}")
    log(f"SIGKILL at step {kill_at} of {steps} (table {cfg['hash_dim']} x "
        f"10, fc {cfg['width']}, B={cfg['batch']}; checkpoints every 2), "
        f"resumed in a new process: every step's loss within {err:.3g} of "
        f"the uninterrupted worker's ({wall:.1f} s for the three workers)")
    return dict(kill_at=kill_at, steps=steps, loss_err=err, wall_s=wall)


@phase("deploy")
def deploy():
    """Checkpoints, export and two-tenant serving: see the module's
    docstring."""
    from paddle_tpu_torch import fluid

    C = _ctr_module()
    work = tempfile.mkdtemp(prefix="deploy_")
    try:
        summary, trained = _deploy_ckpt(fluid, C, work)
        pred, layer, summary["export_launches"], summary["export"] = \
            _deploy_export(work)
        launches, summary["serve"] = _deploy_serve(fluid, C, work, pred,
                                                   layer, trained)
        del pred, layer, trained
        torch.cuda.empty_cache()
        summary["sigkill"] = _deploy_sigkill(C, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    summary["card"] = card_line()
    log("deploy summary: " + json.dumps(summary, default=str))
    return launches


# -- capi: the inference C ABI serving BERT-base's encoder and LeNet -----------
# (a) BERT-base's encoder (12 layers, d_model 768, 12 heads, d_ff 3072) in
# bf16 behind _EncoderF32, exported at DEPLOY_BATCH x SEQ x 768 float32
# under the default FFN arm and served by a ctypes host in a clean
# subprocess: its output bit for bit the in-process Predictor.run's, and
# within SERVE_MAX_ABS / SERVE_MEAN_ABS of the eager encoder; CAPI_RUNS
# PT_PredictorRun calls timed in turns with run_handles + the host copy
# (b) examples/c_inference/predictor_demo.c, compiled unchanged by gcc
# against the library built with libpython, serving LeNet exported on the
# card: its printed logits (6 decimals) within CAPI_LENET_TOL of the
# in-process Predictor's
CAPI_RUNS = 8
CAPI_LENET_TOL = 1e-5

# the ctypes host: imports nothing of the port (nor torch) before
# PT_NewPredictor, so the first CUDA context is made inside the bridge,
# under the GIL that PT_* takes; then one warm-up run, one run with the
# launch counts at 0 (read in this process), the output saved, the -2
# contract and a bad prefix; then, on the parent's go (a line on stdin),
# CAPI_RUNS calls timed in turns with the same work in process
# (run_handles and the one host copy into a buffer kept across calls) and
# with Predictor.run (which allocates its host arrays); one JSON line
_CAPI_HOST = r"""
import ctypes, json, sys, time
import numpy as np

so, prefix, inp, outp, runs = sys.argv[1:6]
runs = int(runs)
lib = ctypes.CDLL(so)
lib.PT_GetLastError.restype = ctypes.c_char_p
lib.PT_Init.argtypes = [ctypes.c_char_p]
lib.PT_NewPredictor.restype = ctypes.c_void_p
lib.PT_NewPredictor.argtypes = [ctypes.c_char_p]
F32P = ctypes.POINTER(ctypes.c_float)
I64P = ctypes.POINTER(ctypes.c_int64)
lib.PT_PredictorRun.argtypes = [
    ctypes.c_void_p, F32P, I64P, ctypes.c_int, F32P, ctypes.c_int64, I64P,
    I64P, ctypes.POINTER(ctypes.c_int)]
lib.PT_DeletePredictor.argtypes = [ctypes.c_void_p]
clean = not any(m == "torch" or m.startswith(("torch.", "paddle_tpu"))
                for m in sys.modules)
assert lib.PT_Init(b"") == 0, lib.PT_GetLastError()
t0 = time.perf_counter()
h = lib.PT_NewPredictor(prefix.encode())
new_s = time.perf_counter() - t0
assert h, lib.PT_GetLastError()
x = np.ascontiguousarray(np.load(inp), np.float32)
shape = (ctypes.c_int64 * x.ndim)(*x.shape)
out = np.zeros(x.size * 2, np.float32)
count, ondim = ctypes.c_int64(), ctypes.c_int()
oshape = (ctypes.c_int64 * 8)()


def run(buf):
    return lib.PT_PredictorRun(
        h, x.ctypes.data_as(F32P), shape, x.ndim, buf.ctypes.data_as(F32P),
        buf.size, ctypes.byref(count), oshape, ctypes.byref(ondim))


assert run(out) == 0, lib.PT_GetLastError()  # warm-up
from paddle_tpu_torch.ops.kernels import COUNTERS
for c in COUNTERS.values():
    c.reset()
rc = run(out)
launches = {n: c.value for n, c in COUNTERS.items()}
assert rc == 0, lib.PT_GetLastError()
got = out[:count.value].reshape([oshape[i] for i in range(ondim.value)])
np.save(outp, got)
small = np.zeros(16, np.float32)
rc_small, small_count = run(small), count.value
import torch
from paddle_tpu_torch import inference
pred = inference.load_inference_model(prefix)
host = torch.empty(tuple(got.shape))
calls = {"abi": lambda: run(out),
         "run_handles": lambda: host.copy_(pred.run_handles([x])[0].torch()),
         "predictor_run": lambda: pred.run([x])}
ms, ev = {k: [] for k in calls}, {k: [] for k in calls}
for call in calls.values():
    call()
sys.stdout.write("ready\n")
sys.stdout.flush()
sys.stdin.readline()  # the parent's go: no other process on the card
turns = list(calls)
for turn in (turns + turns[::-1]) * (runs // 2):
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e0.record()
    calls[turn]()
    e1.record()
    torch.cuda.synchronize()
    ms[turn].append((time.perf_counter() - t0) * 1e3)
    ev[turn].append(e0.elapsed_time(e1))
lib.PT_DeletePredictor(h)
bad = lib.PT_NewPredictor(b"/nonexistent/model")
print(json.dumps(dict(
    clean=clean, new_predictor_s=new_s, launches=launches, count=count.value,
    rc_small=rc_small, small_count=small_count, bad_prefix_null=bad is None,
    bad_prefix_error=lib.PT_GetLastError().decode(), host_ms=ms,
    event_ms=ev)))
"""


class _EncoderF32(torch.nn.Module):
    """An encoder behind the C ABI's contract: one float32 tensor in (the
    embeddings' output, B x S x d_model), one float32 tensor out; the
    encoder's own dtype inside."""

    def __init__(self, encoder, dtype):
        super().__init__()
        self.encoder = encoder
        self.dtype = dtype

    def forward(self, x):
        return self.encoder(x.to(self.dtype)).float()


def _c_host_env():
    """The environment a host process needs to import the port: the repo
    and this interpreter's site-packages on PYTHONPATH (an embedded
    interpreter starts from libpython's prefix, not from a venv's)."""
    import site

    paths = [str(Path(__file__).resolve().parent)] + site.getsitepackages()
    old = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        paths + ([old] if old else [])))


def _capi_encoder(work, so, demo):
    """(a); the ctypes host starts its imports beside (b)'s demo and times
    its calls once the demo has ended, so no other process shares the card
    then.  Returns (the host's launch counts, summary)."""
    from paddle_tpu_torch import inference

    cfg = bert.BertConfig.base()
    model = bert.BertModel(cfg, dtype=torch.bfloat16, seed=0).eval()
    layer = _EncoderF32(model.encoder, torch.bfloat16).eval()
    x = np.random.default_rng(23).standard_normal(
        (DEPLOY_BATCH, SEQ, cfg.hidden_size)).astype(np.float32)
    F._FFN_DISABLED = _FFN_DEFAULT
    try:
        t0 = time.perf_counter()
        prefix = inference.save_inference_model(
            os.path.join(work, "encoder"), layer, [x])
        export_s = time.perf_counter() - t0
        with torch.inference_mode():  # the arm the export took
            eager = layer(torch.from_numpy(x).cuda()).cpu().numpy()
    finally:
        F.enable_fused_ffn()  # main()'s arm for the other phases
    with open(prefix + ".json") as f:
        spec = json.load(f)["inputs"]
    if spec != [{"shape": list(x.shape), "dtype": "float32"}]:
        raise AssertionError(f"the export records inputs {spec}")
    inp, outp = os.path.join(work, "x.npy"), os.path.join(work, "y.npy")
    np.save(inp, x)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", _CAPI_HOST, so, prefix, inp, outp,
         str(CAPI_RUNS)], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_c_host_env())
    ready = ""
    try:
        pred = inference.load_inference_model(prefix)
        ops = _graph_ops(pred)
        counted = {o.split(".")[1]: ops.count(o) for o in set(ops)}
        want_ops = {"flash_forward": LAYERS, "ffn_act_fwd": LAYERS}
        if counted != want_ops:
            raise AssertionError(f"the encoder's graph holds {counted}, "
                                 f"want {want_ops}")
        want = pred.run([x])[0]
        err = np.abs(want - eager)
        if not np.isfinite(want).all() or float(err.max()) > SERVE_MAX_ABS \
                or float(err.mean()) > SERVE_MEAN_ABS:
            raise AssertionError(f"Predictor vs the eager encoder: max abs "
                                 f"{err.max()}, mean {err.mean()}")
        del pred, model, layer
        torch.cuda.empty_cache()
        c_host = demo()
        ready = proc.stdout.readline()
        if ready.strip() == "ready":
            proc.stdin.write("go\n")
            proc.stdin.flush()
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    host_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"ctypes host exit {proc.returncode}:\n"
                             f"{ready}{stdout[-2000:]}\n{stderr[-4000:]}")
    rep = json.loads(stdout.strip().splitlines()[-1])
    got = np.load(outp)
    if got.shape != want.shape or not np.array_equal(
            got.view(np.uint32), want.view(np.uint32)):
        raise AssertionError(f"PT_PredictorRun {got.shape} differs from "
                             f"Predictor.run {want.shape}: max abs "
                             f"{np.abs(got - want).max()}")
    launches = rep["launches"]
    for n, v in launches.items():
        need = LAYERS if n in ("flash_fwd", "ffn_act_fwd") else 0
        if v != need:
            raise AssertionError(f"PT_PredictorRun launched {n} {v} times, "
                                 f"want {need}")
    if not rep["clean"] or rep["rc_small"] != -2 or \
            rep["small_count"] != want.size or not rep["bad_prefix_null"] \
            or not rep["bad_prefix_error"]:
        raise AssertionError(f"ctypes host contract: {rep}")
    stat = {k: dict(host_ms=float(np.median(rep["host_ms"][k])),
                    event_ms=float(np.median(rep["event_ms"][k])))
            for k in rep["host_ms"]}
    share = stat["abi"]["host_ms"] - stat["run_handles"]["host_ms"]
    summary = dict(
        export_s=export_s, graph_ops=counted, launches={
            n: v for n, v in launches.items() if v},
        max_abs_vs_eager=float(err.max()), mean_abs_vs_eager=float(
            err.mean()), new_predictor_s=rep["new_predictor_s"],
        host_process_s=host_s, medians=stat, abi_share_ms=share,
        host_ms=rep["host_ms"], event_ms=rep["event_ms"],
        bad_prefix_error=rep["bad_prefix_error"][:120], c_host=c_host)
    log(f"C ABI, BERT-base encoder bf16 ({LAYERS} layers) at {DEPLOY_BATCH}"
        f" x {SEQ} x {cfg.hidden_size} f32 in and out, exported in "
        f"{export_s:.1f} s: graph operators {counted}; a clean ctypes host "
        f"(PT_NewPredictor {rep['new_predictor_s']:.1f} s, the process "
        f"{host_s:.1f} s) launched {summary['launches']} in one "
        f"PT_PredictorRun, its output bit for bit Predictor.run's (max abs "
        f"{err.max():.4g} and mean {err.mean():.4g} from the eager "
        f"encoder); -2 with count {rep['small_count']}, a bad prefix NULL "
        f"({summary['bad_prefix_error'][:60]!r}); medians of "
        f"{CAPI_RUNS // 2 * 2} calls each in turns (host clock / CUDA "
        f"events, ms): PT_PredictorRun {stat['abi']['host_ms']:.3f} / "
        f"{stat['abi']['event_ms']:.3f}, run_handles + the same host copy "
        f"{stat['run_handles']['host_ms']:.3f} / "
        f"{stat['run_handles']['event_ms']:.3f}, Predictor.run "
        f"{stat['predictor_run']['host_ms']:.3f} / "
        f"{stat['predictor_run']['event_ms']:.3f}: the ABI's share "
        f"{share:.3f} ms a call")
    return launches, summary


def _capi_c_host(work, so):
    """(b): the reference's pure-C demo against the port's library,
    serving LeNet on the card.  Started here, in the background (its
    interpreter start and imports overlap the encoder's export); returns
    finish(), which waits for it and checks its logits."""
    import sysconfig

    from paddle_tpu_torch import inference
    from paddle_tpu_torch.vision.models import LeNet

    net = LeNet(num_classes=10, device="cuda", seed=3).eval()
    prefix = inference.save_inference_model(
        os.path.join(work, "lenet"), net, [([1, 1, 28, 28], "float32")])
    x = np.random.RandomState(0).uniform(-1, 1, (1, 1, 28, 28)).astype(
        np.float32)
    want = inference.load_inference_model(prefix).run([x])[0].reshape(-1)
    inp = os.path.join(work, "x.f32")
    x.tofile(inp)
    demo = str(Path(__file__).resolve().parent / "examples" / "c_inference"
               / "predictor_demo.c")
    exe, libdir = os.path.join(work, "predictor_demo"), os.path.dirname(so)
    cmd = ["gcc", "-O2", demo, "-o", exe, f"-L{libdir}",
           "-lpaddle_tpu_torch_c", f"-Wl,-rpath,{libdir}",
           f"-L{sysconfig.get_config_var('LIBDIR')}",
           f"-lpython{sysconfig.get_config_var('LDVERSION')}", "-ldl", "-lm"]
    t0 = time.perf_counter()
    cc = subprocess.run(cmd, capture_output=True, text=True)
    cc_s = time.perf_counter() - t0
    if cc.returncode != 0:
        raise AssertionError(f"gcc predictor_demo.c: {cc.stderr[-2000:]}")
    t0 = time.perf_counter()
    proc = subprocess.Popen([exe, str(Path(__file__).resolve().parent),
                             prefix, inp], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=_c_host_env())

    def finish():
        try:
            out, err_text = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        run_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"predictor_demo exit {proc.returncode}:\n"
                                 f"{out[-1000:]}\n{err_text[-3000:]}")
        got = np.asarray([float(ln.split("=")[1]) for ln in
                          out.splitlines() if ln.startswith("out[")],
                         np.float32)
        err = float(np.abs(got - want).max()) if got.shape == want.shape \
            else float("inf")
        if err > CAPI_LENET_TOL:
            raise AssertionError(f"predictor_demo printed {got}, the "
                                 f"Predictor gives {want} (max abs {err})")
        log(f"pure-C host: examples/c_inference/predictor_demo.c compiled "
            f"unchanged by gcc in {cc_s:.2f} s against {so}; served LeNet "
            f"on the card in {run_s:.1f} s of process (interpreter, import, "
            f"load, one run; beside the encoder's export): {len(got)} "
            f"logits within {err:.3g} of the in-process Predictor's")
        return dict(gcc_s=cc_s, process_s=run_s, max_abs=err)

    finish.proc = proc
    return finish


@phase("capi")
def capi():
    """The inference C ABI: see _CAPI_HOST and the constants above."""
    from paddle_tpu_torch import core_native

    work, demo = tempfile.mkdtemp(prefix="capi_"), None
    try:
        t0 = time.perf_counter()
        so = core_native.build_c_api(embed=True)
        build_s = time.perf_counter() - t0
        log(f"g++ built {so} (linked with libpython) in {build_s:.2f} s")
        demo = _capi_c_host(work, so)
        launches, summary = _capi_encoder(work, so, demo)
    finally:
        if demo is not None and demo.proc.poll() is None:
            demo.proc.kill()
            demo.proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    summary.update(build_s=build_s, card=card_line())
    log("capi summary: " + json.dumps(summary, default=str))
    return launches


# -- feed: BASELINE configs[0] trained from files, the 1.x way -----------------
# MNIST's size (60000 train images, 28 x 28 u8) written as IDX gzip files
# from FEED_SEED: each class a random template, each image its class's
# template plus noise, so the program can learn; one epoch of
# models/mnist.py's program (Adam lr 1e-3) at FEED_BATCH (937 steps) fed by
# paddle.batch(reader.shuffle(reader.map_readers(..., dataset.mnist.train
# (...)), FEED_SHUFFLE)) through fluid.io.PyReader, and again through
# DataLoader.from_generator(...).set_sample_generator over xmap_readers
# (FEED_WORKERS, ordered), from one state; each epoch's last FEED_PROFILED
# steps run under the profiler.  Both loaders' first FEED_HOLD losses
# equal bit for bit those of a run fed the same batches straight from
# numpy; every loss finite, the last 50 steps' mean below the first 50's.
# Then FEED_HOLD of those batches, made on the card first, through
# from_generator's set_batch_generator: each reaches the Executor as the
# same tensor, with no sync, and the losses are again the numpy-fed
# run's.  cuDNN is deterministic for the phase (its search off), so runs
# of one batch order can agree
FEED_TRAIN, FEED_BATCH, FEED_SHUFFLE, FEED_CAPACITY = 60000, 64, 8192, 16
FEED_WORKERS, FEED_XMAP_BUFFER, FEED_SEED = 4, 256, 0
FEED_HOLD, FEED_PROFILED = 20, 50


def _feed_files(work):
    """MNIST-format train-images / train-labels IDX gzip files."""
    import gzip
    import struct

    rng = np.random.default_rng(FEED_SEED)
    templates = rng.integers(0, 256, (10, 28, 28)).astype(np.float32)
    labels = rng.integers(0, 10, FEED_TRAIN).astype(np.uint8)
    noise = rng.normal(0.0, 48.0, (FEED_TRAIN, 28, 28)).astype(np.float32)
    images = np.clip(templates[labels] + noise, 0, 255).astype(np.uint8)
    ip = os.path.join(work, "train-images-idx3-ubyte.gz")
    lp = os.path.join(work, "train-labels-idx1-ubyte.gz")
    with gzip.open(ip, "wb", compresslevel=1) as f:
        f.write(struct.pack(">IIII", 2051, FEED_TRAIN, 28, 28))
        f.write(images.tobytes())
    with gzip.open(lp, "wb", compresslevel=1) as f:
        f.write(struct.pack(">II", 2049, FEED_TRAIN))
        f.write(labels.tobytes())
    return (ip, lp), images, labels


def _as_chw(sample):
    """dataset.mnist's (784 floats in [-1, 1], label) as the program's
    (1 x 28 x 28 image, [label] int64)."""
    img, label = sample
    return img.reshape(1, 28, 28), np.array([label], np.int64)


def _numpy_batches(images, labels, steps):
    """The batches the readers give under random.seed(FEED_SEED), made
    straight from the arrays: reader.shuffle's buffers of FEED_SHUFFLE
    shuffled in turn (random.shuffle draws by the list's length only),
    dataset.mnist's scaling in float32."""
    import random

    random.seed(FEED_SEED)
    order = []
    for s in range(0, FEED_TRAIN, FEED_SHUFFLE):
        chunk = list(range(s, min(s + FEED_SHUFFLE, FEED_TRAIN)))
        random.shuffle(chunk)
        order += chunk
    for k in range(steps):
        idx = np.asarray(order[k * FEED_BATCH:(k + 1) * FEED_BATCH])
        img = images[idx].reshape(-1, 784).astype(np.float32) / 127.5 - 1.0
        yield {"img": img.reshape(-1, 1, 28, 28),
               "label": labels[idx].astype(np.int64).reshape(-1, 1)}


def _feed_loader(fluid, kind, samples, feeds):
    """A fresh loader of one epoch over `samples` (dataset.mnist.train's
    reader creator, which read the files once), its shuffle seeded."""
    import random

    random.seed(FEED_SEED)
    if kind == "pyreader":
        reader = paddle.batch(paddle.reader.shuffle(paddle.reader.map_readers(
            _as_chw, samples), FEED_SHUFFLE), FEED_BATCH, drop_last=True)
        loader = fluid.io.PyReader(feed_list=feeds, capacity=FEED_CAPACITY,
                                   iterable=True)
        loader.decorate_sample_list_generator(reader,
                                              places=fluid.CUDAPlace(0))
        return loader
    mapped = paddle.reader.xmap_readers(
        _as_chw, paddle.reader.shuffle(samples, FEED_SHUFFLE), FEED_WORKERS,
        FEED_XMAP_BUFFER, order=True)
    return fluid.io.DataLoader.from_generator(
        feed_list=feeds, capacity=FEED_CAPACITY, return_list=False
    ).set_sample_generator(mapped, FEED_BATCH, drop_last=True,
                           places=fluid.CUDAPlace(0))


def _feed_steps(exe, main, scope, loss, it, steps=None):
    """Steps over the feeds of `it`: (the loss handles, host s waiting on
    the first feed (the shuffle buffer's fill), host s waiting on the
    others, host s in Executor.run)."""
    handles, waits, run = [], [], 0.0
    while steps is None or len(handles) < steps:
        t0 = time.perf_counter()
        feed = next(it, None)
        t1 = time.perf_counter()
        if feed is None:
            break
        handles.append(exe.run(main, feed=feed, fetch_list=[loss],
                               scope=scope, return_numpy=False)[0])
        waits.append(t1 - t0)
        run += time.perf_counter() - t1
    return handles, sum(waits[:1]), sum(waits[1:]), run


@phase("feed")
def feed():
    """BASELINE configs[0] trained from MNIST-format files: see the
    constants above."""
    t_phase = time.perf_counter()
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.dataset import mnist
    from paddle_tpu_torch.models import mnist as M

    work = tempfile.mkdtemp(prefix="feed_")
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        t0 = time.perf_counter()
        paths, images, labels = _feed_files(work)
        write_s = time.perf_counter() - t0
        raw = sum(os.path.getsize(p) for p in paths)
        t0 = time.perf_counter()
        samples = mnist.train(*paths)
        read_s = time.perf_counter() - t0
        with unique_name.guard():
            main, startup, _, fetches = M.build_train_program()
        loss = fetches[0]
        gb = main.global_block()
        feeds = [gb.var("img"), gb.var("label")]
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        start = _ctr_state(scope)
        steps = FEED_TRAIN // FEED_BATCH
        # warm-up: the program's kernels and the allocator, then back
        _feed_steps(exe, main, scope, loss,
                    iter(_numpy_batches(images, labels, 5)))
        _ctr_restore(scope, start)
        ref = [float(h) for h in _feed_steps(
            exe, main, scope, loss,
            iter(_numpy_batches(images, labels, FEED_HOLD)))[0]]
        on_card = [[torch.from_numpy(b["img"]).cuda(),
                    torch.from_numpy(b["label"]).cuda()]
                   for b in _numpy_batches(images, labels, FEED_HOLD)]
        del images, labels
        setup_s = time.perf_counter() - t_phase
        runs, launches = {}, None
        timed = steps - FEED_PROFILED
        for kind in ("pyreader", "from_generator"):
            t_run = time.perf_counter()
            _ctr_restore(scope, start)
            it = iter(_feed_loader(fluid, kind, samples, feeds))
            profiler.stat_reset()
            profiler.time_reset()
            for c in COUNTERS.values():
                c.reset()
            torch.cuda.synchronize()
            # -- the main path: counters at 0 before, read right after --
            with _SyncCount() as sc:
                t0 = time.perf_counter()
                handles, first_s, wait, run = _feed_steps(
                    exe, main, scope, loss, it, timed)
                torch.cuda.synchronize()
                epoch_s = time.perf_counter() - t0
            stats = profiler.get_int_stats()
            # the epoch's last FEED_PROFILED steps, under the profiler
            tail = []
            busy, wall, _ = _profile(lambda: tail.extend(_feed_steps(
                exe, main, scope, loss, it, FEED_PROFILED)[0]), top=8)
            counts = {n: c.value for n, c in COUNTERS.items()}
            # ------------------------------------------------------------
            if launches is None:
                launches = counts
            _expect_launches(counts, 0, (), f"the {kind} epoch")
            if next(it, None) is not None:
                raise AssertionError(f"{kind}: more than {steps} batches")
            del it
            losses = [float(h) for h in handles + tail]
            if len(losses) != steps:
                raise AssertionError(f"{kind}: {len(losses)} steps, "
                                     f"want {steps}")
            first, last = np.mean(losses[:50]), np.mean(losses[-50:])
            if not np.isfinite(losses).all() or not last < first:
                raise AssertionError(f"{kind}: losses {first} -> {last}"
                                     f" (first and last 50 steps)")
            if not np.array_equal(np.float32(losses[:FEED_HOLD]),
                                  np.float32(ref)):
                raise AssertionError(
                    f"{kind}: first losses {losses[:FEED_HOLD]} against "
                    f"the numpy-fed {ref}")
            sites = sc.sites()
            runs[kind] = r = dict(
                steps=steps, timed_steps=timed, seconds=epoch_s,
                samples_per_s=timed * FEED_BATCH / epoch_s,
                first_batch_s=first_s, feed_ms=1e3 * wait / (timed - 1),
                run_ms=1e3 * run / timed,
                host_reads=stats.get("executor_sync_count", 0) / timed,
                syncs=sum(sites.values()) / timed, sync_sites=sites,
                idle=max(0.0, 1 - busy / wall),
                profiled_step_ms=wall / FEED_PROFILED,
                loss_first50=first, loss_last50=last,
                wall_s=time.perf_counter() - t_run)
            log(f"MNIST through {kind}: the epoch's first {timed} of "
                f"{steps} steps in {epoch_s:.2f} s "
                f"({r['samples_per_s']:.0f} samples/s, CUDA-synced host "
                f"clock); the first batch (the shuffle buffer's "
                f"{FEED_SHUFFLE} samples) {first_s:.3f} s, then host ms a "
                f"step waiting on the feed {r['feed_ms']:.3f}, in "
                f"Executor.run {r['run_ms']:.3f}; host reads "
                f"{r['host_reads']:.2f} and syncs {r['syncs']:.2f} a step "
                f"({sites}); idle {100 * r['idle']:.1f}% of the last "
                f"{FEED_PROFILED} steps, profiled; loss {first:.4f} -> "
                f"{last:.4f}; first {FEED_HOLD} losses bit for bit the "
                f"numpy-fed run's")
        # a batch generator of tensors already on the card
        t_run = time.perf_counter()
        _ctr_restore(scope, start)
        loader = fluid.io.DataLoader.from_generator(
            feed_list=feeds, capacity=FEED_CAPACITY, return_list=False
        ).set_batch_generator(lambda: iter(on_card))
        handed, handles = [], []
        torch.cuda.synchronize()
        with _SyncCount() as sc:
            for feed in loader:
                handed.append(feed["img"] is on_card[len(handed)][0]
                              and feed["label"] is on_card[len(handed)][1])
                handles.append(exe.run(main, feed=feed, fetch_list=[loss],
                                       scope=scope, return_numpy=False)[0])
            torch.cuda.synchronize()
        sites = sc.sites()
        losses = [float(h) for h in handles]
        if len(handed) != FEED_HOLD or not all(handed):
            raise AssertionError(f"device batches: {sum(handed)} of "
                                 f"{len(handed)} handed over as they were")
        if sites:
            raise AssertionError(f"device batches: syncs {sites}")
        if not np.array_equal(np.float32(losses), np.float32(ref)):
            raise AssertionError(f"device batches: losses {losses} against "
                                 f"the numpy-fed {ref}")
        runs["device_batches"] = dict(steps=FEED_HOLD, syncs=0.0,
                                      same_objects=True,
                                      wall_s=time.perf_counter() - t_run)
        log(f"a batch generator of tensors on the card through "
            f"from_generator: {FEED_HOLD} steps, each batch the same "
            f"tensors, 0 syncs a step, the losses bit for bit the numpy-fed "
            f"run's")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            det
        shutil.rmtree(work, ignore_errors=True)
    summary = dict(files_bytes=raw, write_s=write_s, read_s=read_s,
                   setup_s=setup_s, steps=steps,
                   numpy_first=ref[:3], runs=runs, card=card_line())
    log("feed summary: " + json.dumps(summary, default=str))
    return launches


# -- data parallelism over torch.distributed (phase 28) --------------------------

# the ranks' runs: with two or more cards one NCCL group of min(cards, 4)
# ranks, a card each; with one card a world-one NCCL group (every rule
# through NCCL), then two gloo ranks sharing the card (asked for by
# PADDLE_DISTRI_BACKEND=gloo, as Paddle 2.x selects it)
DIST_STEPS = 3
DIST_BERT_BATCH, DIST_BERT_MASKED = 32, 76
DIST_RESNET_BATCH = 128
# one collective of f32 shards over <= 4 ranks: NCCL's (or gloo's) order
# of the sums against numpy's; prod through exp/log; moves exactly
DIST_RULE_TOL = dict(atol=1e-5, rtol=1e-5)
# BERT-base bf16: the data-parallel step's global mean loss against one
# process's on the whole batch, relative.  Step 1 is a forward of the
# same masters: the rows' kernels at other batch sizes (cuBLAS may take
# other tiles at M = B*S/2) round bf16 elsewhere (measured 5.8e-6 on an
# H100, PERF.md).  Later steps part by AdamW's first updates, which move
# every element by about lr whatever its gradient's size: where a
# gradient is within bf16's rounding of 0 its sign is the rounding's,
# and the losses part by the curvature over those elements (measured
# 6.0e-5 to 3.3e-4 at steps 2 and 3)
DIST_LOSS1_RTOL = 1e-4
DIST_LOSS_RTOL = 1e-3
# the static ResNet-50's step-1 loss with the group's batch statistics
# (float32 sums all-reduced) against cuDNN's batch norm over the whole
# batch in one process: f32 sums in other orders through 53 norms
DIST_SBN_RTOL = 1e-4
# a rank's step-1 loss against the forward of its rows in the same
# process: the same ops on the same card (cuDNN deterministic); the
# train program runs them with autograd recording, which may take other
# kernels only in the last bits
DIST_FWD_RTOL = 1e-6


def _dist_plan(cards):
    if cards >= 2:
        n = min(cards, 4)
        return [("nccl", n, list(range(n)), ("rules", "bert", "resnet"))]
    return [("nccl", 1, [0], ("rules",)),
            ("gloo", 2, [0], ("rules", "bert", "resnet"))]


def _fingerprint(tensors):
    """Two int64 sums a tensor of its float32 words (plain and weighted
    by position): equal across ranks only for equal bits, to the odds of
    a collision."""
    fp = []
    for t in tensors:
        b = t.detach().reshape(-1).view(torch.int32).to(torch.int64)
        w = torch.arange(b.numel(), device=b.device) % 65521 + 1
        fp.append(torch.stack([b.sum(), (b * w).sum()]))
    return torch.stack(fp)


def _same_on_every_rank(fp, what):
    from paddle_tpu_torch.distributed import comm

    got = comm.all_gather(fp[None])
    if not bool((got == got[:1]).all()):
        raise AssertionError(f"{what}: the ranks' parameters differ")


def _dist_rules(world, rank, dev):
    """Every collective rule once on CUDA tensors at this world, against
    numpy oracles of the same seeded shards (every rank draws them all).
    Returns {case: max abs err}."""
    from paddle_tpu_torch.fluid import framework as TFW
    from paddle_tpu_torch.ops import registry as TREG

    def op(t, attrs, ins=("X",), outs=("Out",)):
        return TFW.Operator(TFW.Program().global_block(), 0, t,
                            {s: [f"{s}_0"] for s in ins},
                            {s: [f"{s}_0"] for s in outs}, dict(attrs))

    def ctx():
        return TREG.LowerCtx(0, device=dev)

    rng = np.random.RandomState(5)

    def shards(*shape, pos=False):
        x = rng.uniform(0.5, 1.5, (world,) + shape) if pos \
            else rng.randn(world, *shape)
        return x.astype(np.float32)

    root, src, dst = world - 1, min(1, world - 1), world - 1
    piece = 8 // world

    def a2a(x, r):
        return np.concatenate([x[k].reshape(world, -1, 3)[r]
                               for k in range(world)])

    def p2p(x, r):
        return x[src] if r == dst else np.zeros_like(x[r])

    x43, x83, x23, x28 = shards(4, 3), shards(8, 3), shards(2, 3), \
        shards(2, 8)
    xpos = shards(4, 3, pos=True)
    cases = [
        ("c_allreduce_sum", {}, x43, lambda x, r: x.sum(0)),
        ("c_allreduce_max", {}, x43, lambda x, r: x.max(0)),
        ("c_allreduce_min", {}, x43, lambda x, r: x.min(0)),
        ("c_allreduce_prod", {}, xpos, lambda x, r: x.prod(0)),
        ("mp_allreduce_sum", {}, x43, lambda x, r: x.sum(0)),
        ("c_reduce_sum", {"root_id": 0}, x43, lambda x, r: x.sum(0)),
        ("c_broadcast", {"root": root}, x43, lambda x, r: x[root]),
        ("c_allgather", {"nranks": world}, x23,
         lambda x, r: np.concatenate(list(x))),
        ("c_reducescatter", {}, x83,
         lambda x, r: x.sum(0).reshape(world, -1, 3)[r]),
        ("c_concat", {}, x23, lambda x, r: np.concatenate(list(x), -1)),
        ("c_split", {}, x28,
         lambda x, r: x[r][..., r * piece:(r + 1) * piece]),
        ("c_identity", {}, x43, lambda x, r: x[r]),
        ("alltoall", {}, x83, a2a),
        ("barrier", {}, x43, lambda x, r: x[r]),
        ("c_sync_calc_stream", {}, x43, lambda x, r: x[r]),
        ("c_sync_comm_stream", {}, x43, lambda x, r: x[r]),
    ]
    errs = {}
    for name, attrs, x, want in cases:
        got = TREG.forward_rule(name)(
            ctx(), op(name, {"ring_id": 0, **attrs}),
            {"X": [torch.from_numpy(x[rank]).to(dev)]})["Out"][0]
        ok, err = close(got.cpu(), torch.from_numpy(want(x, rank)),
                        **DIST_RULE_TOL)
        if not ok or got.device != dev:
            raise AssertionError(f"{name}: max abs err {err} on {got.device}")
        errs[name] = err
    # issued on the comm stream, then the fence: the compute stream waits
    got = TREG.forward_rule("c_allreduce_sum")(
        ctx(), op("c_allreduce_sum", {"ring_id": 0, "use_calc_stream": False}),
        {"X": [torch.from_numpy(x43[rank]).to(dev)]})["Out"][0]
    TREG.forward_rule("c_sync_comm_stream")(
        ctx(), op("c_sync_comm_stream", {"ring_id": 0}), {"X": [got]})
    ok, errs["comm_stream_sum"] = close((got * 1.0).cpu(),
                                        torch.from_numpy(x43.sum(0)),
                                        **DIST_RULE_TOL)
    if not ok:
        raise AssertionError("the comm-stream all-reduce after its fence")
    for name in ("c_comm_init", "c_comm_init_all", "c_gen_nccl_id",
                 "c_wait_calc_stream", "c_wait_comm_stream"):
        if TREG.forward_rule(name)(ctx(), op(name, {}, (), ()), {}) != {}:
            raise AssertionError(name)
        errs[name] = 0.0
    c = ctx()
    TREG.forward_rule("send_v2")(c, op("send_v2", {"peer": dst}, ("X",), ()),
                                 {"X": [torch.from_numpy(x43[rank]).to(dev)]})
    got = TREG.forward_rule("recv_v2")(
        c, op("recv_v2", {"peer": src, "out_shape": [4, 3]}, (), ("Out",)),
        {})["Out"][0]
    if not torch.equal(got.cpu(), torch.from_numpy(p2p(x43, rank))):
        raise AssertionError("send_v2 / recv_v2")
    errs["send_v2+recv_v2"] = 0.0
    torch.cuda.synchronize()
    return errs


def _dist_bert(world, rank, dev):
    """BERT-base's data-parallel pretraining step at full width, bf16 over
    f32 masters, dropout 0: DIST_STEPS steps on this rank's rows of the
    global batch, the launch counters at 0 just before and read just
    after, the parameters' bits compared across the ranks after each
    step (and whole at the end)."""
    from paddle_tpu_torch.distributed import comm
    from paddle_tpu_torch.parallel import mesh as M

    cfg = bert.BertConfig.base(hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)
    model = bert.BertForPretraining(cfg, seed=0)
    mesh = M.make_mesh({"dp": world})
    step, state = bert.build_pretrain_step(model, mesh=mesh, dp_axis="dp")
    del model
    fb = bert.fake_batch(cfg, DIST_BERT_BATCH, SEQ,
                         num_masked=DIST_BERT_MASKED, seed=11)
    mine = {k: torch.from_numpy(v).to(dev)
            for k, v in M.shard_host_batch(mesh, fb).items()}
    n_params = sum(v.numel() for v in state["params"].values())
    reduce_times = []
    dp_mean = bert._dp_mean

    def timed_dp_mean(grads, loss, group, n):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        h0 = time.perf_counter()
        e0.record()
        out = dp_mean(grads, loss, group, n)
        e1.record()
        reduce_times.append((time.perf_counter() - h0, e0, e1))
        return out

    bert._dp_mean = timed_dp_mean
    torch.cuda.synchronize()
    for c in COUNTERS.values():
        c.reset()
    # -- the main path: counters at 0 before, read right after --------------
    losses, step_ms, host_ms = [], [], []
    try:
        for _ in range(DIST_STEPS):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            h0 = time.perf_counter()
            e0.record()
            state, loss = step(state, mine, TRAIN_LR)
            e1.record()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - h0) * 1e3)
            step_ms.append(e0.elapsed_time(e1))
            losses.append(float(loss))
            _same_on_every_rank(_fingerprint(state["params"].values()),
                                f"bert step {len(losses)}")
        launches = {n: c.value for n, c in COUNTERS.items()}
    finally:
        bert._dp_mean = dp_mean
    # ------------------------------------------------------------------------
    flat = torch.cat([v.reshape(-1) for v in state["params"].values()])
    if not torch.equal(comm.broadcast(flat, 0), flat):
        raise AssertionError("bert: the ranks' masters differ after the steps")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"bert losses {losses}")
    _expect_launches(launches, LAYERS * DIST_STEPS, TRAIN_KERNELS,
                     f"{DIST_STEPS} data-parallel BERT steps")
    return dict(losses=losses, step_ms=step_ms, host_step_ms=host_ms,
                allreduce_ms_events=[e0.elapsed_time(e1)
                                     for _, e0, e1 in reduce_times],
                allreduce_ms_host=[h * 1e3 for h, _, _ in reduce_times],
                allreduce_bytes=4 * (n_params + 1), launches=launches,
                rows=int(mine["input_ids"].shape[0]))


class _NoOptimizer:
    """build_train_program's optimizer for the forward alone."""

    def minimize(self, loss):
        return [], []


def _dist_resnet_program(optimizer):
    from paddle_tpu_torch.models import resnet as R

    with unique_name.guard():
        main, startup, _, fetches = R.build_train_program(
            depth=50, class_num=FLUID_CLASSES,
            image_shape=(3, FLUID_HW, FLUID_HW), optimizer=optimizer)
    main.random_seed = startup.random_seed = 7
    return main, startup, fetches


def _dist_resnet_batch():
    rng = np.random.RandomState(0)
    return (rng.randn(DIST_RESNET_BATCH, 3, FLUID_HW, FLUID_HW)
            .astype("float32"),
            rng.randint(0, FLUID_CLASSES, (DIST_RESNET_BATCH, 1))
            .astype("int64"))


def _dist_forward_loss(fluid, x, y):
    """One process's forward of rows (x, y) from the startup values:
    the train program's forward ops, batch norm in training mode."""
    main, startup, fetches = _dist_resnet_program(_NoOptimizer())
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    (loss,) = exe.run(main, feed={"image": x, "label": y},
                      fetch_list=fetches[:1], scope=scope)
    return float(np.asarray(loss).reshape(-1)[0])


def _quant_env(on: bool) -> None:
    """FLAGS_quant_collectives through its environment variable (read at
    each collective, PADDLE_QUANT_COLLECTIVES)."""
    if on:
        os.environ["PADDLE_QUANT_COLLECTIVES"] = "int8"
    else:
        os.environ.pop("PADDLE_QUANT_COLLECTIVES", None)


# the reference's health bound of the quantized collectives
# (tests/test_quant_collectives.py): int8 losses within 5 % of full width,
# and the gradients' wire bytes at least 3.5x fewer
QUANT_HEALTH_RTOL = 0.05
QUANT_MIN_DROP = 3.5


def _quant_health(what, q, full, key):
    """Hold an int8 run against its full-width twin: losses within
    QUANT_HEALTH_RTOL, the counted wire bytes QUANT_MIN_DROP fewer."""
    rel = np.abs(np.array(q["losses"]) - np.array(full["losses"])) \
        / np.abs(np.array(full["losses"]))
    fb, qb = sum(full[key].values()), sum(q[key].values())
    q["rel_err_full_width"] = rel.tolist()
    q["wire_drop"] = fb / max(qb, 1)
    if rel.max() > QUANT_HEALTH_RTOL or fb < QUANT_MIN_DROP * qb:
        raise AssertionError(f"{what}: losses {q['losses']} against full "
                             f"width {full['losses']} (rel {rel}), wire "
                             f"bytes {qb} against {fb}")


def _dist_resnet(world, rank, dev, sync_bn, quant=False):
    """BASELINE configs[4]'s Fleet path on the static ResNet-50:
    fleet.init(is_collective=True) -> distributed_optimizer(Momentum) ->
    GraphExecutionOptimizer -> GradAllReduce ->
    CompiledProgram.with_data_parallel, this rank's rows of a global
    batch of DIST_RESNET_BATCH at 224^2, f32.  Per-rank batch norm:
    DIST_STEPS steps, one c_allreduce_sum a parameter gradient, the
    parameters' bits the same on every rank after each step, step 1's
    loss a one-process forward of the same rows.  `sync_bn`: one step
    with BuildStrategy.sync_batch_norm (the sync_batch_norm rules).
    `quant`: with FLAGS_quant_collectives=int8 (the gradients'
    c_allreduce_sum as int8 blocks), their bytes counted."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.distributed import fleet

    fleet.init(is_collective=True)
    opt = fleet.distributed_optimizer(fluid.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9,
        regularization=fluid.regularizer.L2Decay(1e-4)))
    main, startup, fetches = _dist_resnet_program(opt)
    applied = fleet.fleet.applied_meta_list()
    if applied != ["GraphExecutionOptimizer"]:
        raise AssertionError(f"applied meta-optimizers {applied}")
    ops = main.global_block().ops
    params = [p.name for p in main.all_parameters() if p.trainable]
    n_allreduce = sum(op.type == "c_allreduce_sum" for op in ops)
    if n_allreduce != len(params):
        raise AssertionError(f"{n_allreduce} c_allreduce_sum for "
                             f"{len(params)} parameter gradients")
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    bs = fluid.BuildStrategy()
    bs.sync_batch_norm = sync_bn
    prog = fluid.CompiledProgram(main, bs).with_data_parallel(
        loss_name=fetches[0].name)
    x, y = _dist_resnet_batch()
    k = DIST_RESNET_BATCH // world
    feed = {"image": torch.from_numpy(x[rank * k:(rank + 1) * k]).to(dev),
            "label": torch.from_numpy(y[rank * k:(rank + 1) * k]).to(dev)}
    losses, host_ms = [], []
    _quant_env(quant)
    before = profiler.get_int_stats()
    try:
        for _ in range(1 if sync_bn else DIST_STEPS):
            h0 = time.perf_counter()
            (loss, _) = exe.run(prog, feed=feed, fetch_list=fetches,
                                scope=scope)
            host_ms.append((time.perf_counter() - h0) * 1e3)
            losses.append(float(np.asarray(loss).reshape(-1)[0]))
            _same_on_every_rank(_fingerprint([scope.get(n) for n in params]),
                                f"resnet step {len(losses)}")
    finally:
        _quant_env(False)
    after = profiler.get_int_stats()
    wire = {k: after[k] - before.get(k, 0) for k in after
            if k == "collective_bytes_c_allreduce_sum"}
    if not all(np.isfinite(losses)):
        raise AssertionError(f"resnet losses {losses}")
    out = dict(losses=losses, host_step_ms=host_ms, rows=k,
               allreduce_ops=n_allreduce, grads=len(params),
               allreduce_bytes=4 * sum(int(scope.get(n).numel())
                                       for n in params),
               wire_bytes=wire)
    if not sync_bn:
        want = _dist_forward_loss(fluid, feed["image"], feed["label"])
        if abs(losses[0] - want) > DIST_FWD_RTOL * abs(want):
            raise AssertionError(f"rank {rank} step-1 loss {losses[0]!r} vs "
                                 f"its rows' one-process forward {want!r}")
        out["forward_loss"] = want
    return out


def dist_rank(workdir, tag, parts):
    """One rank of the dist phase (started by distributed.spawn): joins
    the group the launcher's PADDLE_* contract describes and writes what
    it measured to workdir/tag.RANK.json.  Any failure exits non-zero."""
    import paddle_tpu_torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    F.enable_fused_ffn()
    env = dist.init_parallel_env()
    dev = dist.parallel.device()
    rank, world = env.rank, env.world_size
    out = dict(rank=rank, world=world, backend=dist.parallel.backend(),
               device=str(dev), card=card_line())
    t0 = time.perf_counter()
    if "rules" in parts:
        out["rules"] = _dist_rules(world, rank, dev)
    if "bert" in parts:
        out["bert"] = _dist_bert(world, rank, dev)
        torch.cuda.empty_cache()
    if "resnet" in parts:
        out["resnet"] = _dist_resnet(world, rank, dev, sync_bn=False)
        out["resnet_sync_bn"] = _dist_resnet(world, rank, dev, sync_bn=True)
        out["resnet_int8"] = _dist_resnet(world, rank, dev, sync_bn=False,
                                          quant=True)
        _quant_health("dist resnet int8", out["resnet_int8"],
                      out["resnet"], "wire_bytes")
    out["rank_s"] = time.perf_counter() - t0
    with open(os.path.join(workdir, f"{tag}.{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_parallel_env()


def _dist_one_process(fluid, bert_runs, resnet_runs):
    """The one-process references on this card: BERT-base's step on the
    whole batch from the same seed, and the static ResNet-50's forward of
    the whole batch."""
    cfg = bert.BertConfig.base(hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)
    model = bert.BertForPretraining(cfg, seed=0)
    step, state = bert.build_pretrain_step(model)
    del model
    fb = bert.fake_batch(cfg, DIST_BERT_BATCH, SEQ,
                         num_masked=DIST_BERT_MASKED, seed=11)
    batch = {k: torch.from_numpy(v).cuda() for k, v in fb.items()}
    want = []
    for _ in range(DIST_STEPS):
        state, loss = step(state, batch, TRAIN_LR)
        want.append(float(loss))
    del state, step
    torch.cuda.empty_cache()
    for tag, runs in bert_runs.items():
        got = np.mean([r["losses"] for r in runs], axis=0)
        rel = np.abs(got - np.asarray(want)) / np.abs(np.asarray(want))
        log(f"dist {tag}: BERT rank-mean losses {got.tolist()} against one "
            f"process {want}: rel err {rel.tolist()} (step 1 rtol "
            f"{DIST_LOSS1_RTOL}, then {DIST_LOSS_RTOL})")
        if rel[0] > DIST_LOSS1_RTOL or rel.max() > DIST_LOSS_RTOL:
            raise AssertionError(f"{tag}: BERT losses off by {rel}")
    x, y = _dist_resnet_batch()
    whole = _dist_forward_loss(fluid, torch.from_numpy(x).cuda(),
                               torch.from_numpy(y).cuda())
    torch.cuda.empty_cache()
    for tag, runs in resnet_runs.items():
        got = float(np.mean([r["losses"][0] for r in runs]))
        rel = abs(got - whole) / abs(whole)
        log(f"dist {tag}: static ResNet-50 sync_batch_norm step-1 rank-mean "
            f"loss {got!r} against the whole batch's one-process forward "
            f"{whole!r}: rel err {rel:.2e} (rtol {DIST_SBN_RTOL})")
        if rel > DIST_SBN_RTOL:
            raise AssertionError(f"{tag}: sync batch norm loss off by {rel}")
    return want, whole


@phase("dist")
def dist():
    """Phase 28: data parallelism over torch.distributed, each rank a
    process started by the port's distributed.spawn under the PADDLE_*
    contract, loading the kernels the build phase built: (a) every
    collective rule on CUDA tensors against numpy, (b) BERT-base's
    data-parallel step, (c) BASELINE configs[4]'s Fleet path on the
    static ResNet-50 (and once with sync_batch_norm); then the
    one-process references on this card.  Returns rank 0's launches of
    the BERT run."""
    import importlib

    import paddle_tpu_torch.distributed as dist_mod
    from paddle_tpu_torch import fluid

    cards = torch.cuda.device_count()
    plan = _dist_plan(cards)
    card = card_line()
    log(f"dist: {card}; {cards} card(s); runs "
        f"{[(b, n, g) for b, n, g, _ in plan]}")
    # the ranks import this file by name: spawn cannot ship __main__'s
    rank_fn = importlib.import_module("chip_smoke").dist_rank
    root = str(Path(__file__).resolve().parent)
    work = tempfile.mkdtemp(prefix="dist_")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    results, bert_runs, sbn_runs, launches = {}, {}, {}, None
    try:
        for backend, n, gpus, parts in plan:
            tag = f"{backend}{n}"
            env = {"PADDLE_DISTRI_BACKEND": backend,
                   "PYTHONPATH": os.pathsep.join(
                       [root] + [p for p in os.environ.get(
                           "PYTHONPATH", "").split(os.pathsep) if p])}
            t0 = time.perf_counter()
            dist_mod.spawn(rank_fn, args=(work, tag, parts), nprocs=n,
                           gpus=gpus, env=env)
            wall = time.perf_counter() - t0
            runs = [json.load(open(os.path.join(work, f"{tag}.{r}.json")))
                    for r in range(n)]
            results[tag] = runs
            got = {(r["backend"], r["world"]) for r in runs}
            if got != {(backend, n)}:
                raise AssertionError(f"{tag}: the ranks ran {got}")
            log(f"dist {tag}: backend {backend}, world {n}, cards {gpus} "
                f"({cards} on the host); spawn to exit {wall:.1f} s; ranks "
                f"{[round(r['rank_s'], 1) for r in runs]} s of work; rule "
                f"max abs err {max(max(r['rules'].values()) for r in runs):.2e}"
                f" over {len(runs[0]['rules'])} checks a rank")
            if "bert" in parts:
                b = [r["bert"] for r in runs]
                bert_runs[tag] = b
                launches = launches or b[0]["launches"]
                for r, x in enumerate(b):
                    log(f"dist {tag} rank {r}: BERT-base dp step B="
                        f"{x['rows']}/{DIST_BERT_BATCH} S={SEQ}: losses "
                        f"{x['losses']}; step ms (CUDA events) "
                        f"{[round(v, 3) for v in x['step_ms']]}, host "
                        f"{[round(v, 3) for v in x['host_step_ms']]}; "
                        f"all-reduce ms a step (CUDA events) "
                        f"{[round(v, 3) for v in x['allreduce_ms_events']]},"
                        f" host clock "
                        f"{[round(v, 3) for v in x['allreduce_ms_host']]}; "
                        f"{x['allreduce_bytes']} bytes all-reduced a step; "
                        f"launches {x['launches']}")
            if "resnet" in parts:
                sbn_runs[tag] = [r["resnet_sync_bn"] for r in runs]
                for r, x in enumerate(r["resnet"] for r in runs):
                    log(f"dist {tag} rank {r}: static ResNet-50 Fleet "
                        f"B={x['rows']}/{DIST_RESNET_BATCH}: losses "
                        f"{x['losses']} (step 1 = its rows' one-process "
                        f"forward {x['forward_loss']!r}); host ms a step "
                        f"{[round(v, 1) for v in x['host_step_ms']]}; "
                        f"{x['allreduce_ops']} c_allreduce_sum for "
                        f"{x['grads']} gradients, {x['allreduce_bytes']} "
                        f"bytes a step")
                for r, x in enumerate(r["resnet_int8"] for r in runs):
                    log(f"dist {tag} rank {r}: static ResNet-50 Fleet with "
                        f"FLAGS_quant_collectives=int8: losses "
                        f"{x['losses']} (rel err against full width "
                        f"{x['rel_err_full_width']}, bound "
                        f"{QUANT_HEALTH_RTOL}); c_allreduce_sum wire bytes "
                        f"{x['wire_bytes']} in {DIST_STEPS} steps, "
                        f"{x['wire_drop']:.2f}x fewer than full width; host "
                        f"ms a step {[round(v, 1) for v in x['host_step_ms']]}")
        want, whole = _dist_one_process(fluid, bert_runs, sbn_runs)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    summary = dict(card=card, cards=cards, runs={
        tag: [{k: v for k, v in r.items() if k != "rules"} for r in runs]
        for tag, runs in results.items()}, one_process_bert=want,
        one_process_resnet_forward=whole)
    log("dist summary: " + json.dumps(summary, default=str))
    return launches


# -- model parallelism over torch.distributed (phase 29) -------------------------

# the ranks: with four or more cards one NCCL group of 4, a card each; with
# fewer, two gloo ranks sharing card 0 (PADDLE_DISTRI_BACKEND=gloo)
SPMD_STEPS = 3
SPMD_BERT_BATCH = {"nccl": 32, "gloo": 8}
SPMD_DROPOUT = 0.1
# the tensor-parallel BERT-base step (bf16 forward) against one process's
# step on the same batch and seed, relative, every step.  Each rank
# rounds its row-parallel partial product to bf16 before the all-reduce
# adds the ranks' (one process rounds the f32 sum once): a few bf16 units
# (2^-8) on those sums, averaged over the 76 x 32 masked positions'
# log-softmax
SPMD_LOSS_RTOL = 5e-3
# the gathered masters against one process's, absolute: AdamW moves an
# element by about lr a step whatever its gradient's size (|m^/sqrt(v^)|
# is at most 1.0034 over steps 1-3 at b1 0.9, b2 0.999; the decay adds
# under 1e-3 of that), so where a gradient is within bf16's rounding of
# 0 its sign is the rounding's and the element may move the other way:
# 2.01 lr a step at most
SPMD_MASTER_ATOL = 2.01 * SPMD_STEPS * TRAIN_LR
# the static ResNet-50 through the SPMD arm against the same rows'
# replicated run, each rank's loss at steps 1 and 2: step 1 is the same
# forward, step 2 follows one update whose f32 gradient means are formed
# in another order (Fleet's transpiled program scales and all-reduces
# each gradient where the arm reduce-scatters the sum, then scales; one
# f32 unit apart on the CPU's 2-rank rehearsal).  A third step is not
# compared: at lr 0.1 the second update carries those units to 3.7e-3
# of the loss (my chip call 2, PR 26)
SPMD_RESNET_STEPS = 2
SPMD_RESNET_RTOL = 1e-4


def _spmd_plan(cards):
    if cards >= 4:
        return [("nccl", 4, [0, 1, 2, 3])]
    return [("gloo", 2, [0])]


def _tp_flash(g, rows):
    """The flash kernels on a tensor-parallel rank's heads: q/k/v
    (32, 512, 3, 64), heads 6-8 of 12 (rank 2 of mp 4), key padding,
    dropout 0.1: against the plain versions at that offset, and bit for
    bit against the whole 12 heads' launch sliced to them (the same
    masks); then graph-timed in turns with SDPA at that shape."""
    b, s, h, d, mp, r, p, seed = 32, SEQ, 12, 64, 4, 2, SPMD_DROPOUT, 4321
    hl = h // mp
    sl = slice(r * hl, (r + 1) * hl)
    q, k, v, gr = (_rand(g, b, s, h, d) for _ in range(4))
    bias = _padding_bias(g, b, s)
    full, full_lse = A.flash_forward(q, k, v, bias, seed, False, None, None,
                                     p)
    fdq, fdk, fdv = A.flash_backward(q, k, v, bias, seed, full, full_lse, gr,
                                     False, None, None, p)
    ql, kl, vl, gl = (t[:, :, sl].contiguous() for t in (q, k, v, gr))
    out, lse = A.flash_forward(ql, kl, vl, bias, seed, False, None, None, p,
                               h, r * hl)
    out0, _ = A.flash_forward(ql, kl, vl, bias, seed, False, None, None, p)
    grads = A.flash_backward(ql, kl, vl, bias, seed, out, lse, gl, False,
                             None, None, p, h, r * hl)
    torch.cuda.synchronize()
    ref_out, ref_lse = A.flash_forward_reference(ql, kl, vl, bias, seed,
                                                 False, None, None, p, h,
                                                 r * hl)
    refs = A.flash_backward_reference(ql, kl, vl, bias, seed, out, lse, gl,
                                      False, None, None, p, h, r * hl)
    ok_o, err_o = close(out, ref_out, **BF16_TOL)
    ok_l, _ = close(lse, ref_lse, **LSE_TOL)
    checks = {n: close_grad(a, w) for n, a, w in zip(("dq", "dk", "dv"),
                                                       grads, refs)}
    same = (torch.equal(out, full[:, :, sl]) and torch.equal(
        lse, full_lse[:, sl]) and all(torch.equal(a, w[:, :, sl]) for a, w in
                                      zip(grads, (fdq, fdk, fdv))))
    moved = not torch.equal(out0, out)
    ok = ok_o and ok_l and all(c[0] for c in checks.values()) and same \
        and moved
    log(f"spmd flash at heads {sl.start}-{sl.stop - 1} of {h} "
        f"(q/k/v ({b},{s},{hl},{d}), p={p}): O err {err_o:.3g}, "
        + " ".join(f"{n} err {c[1]:.3g}" for n, c in checks.items())
        + f"; the whole launch's bits sliced {same}; other bits than "
        f"offset 0 {moved} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError("the flash kernels at a head offset")
    rows["flash_fwd"]["max_abs_err"] = err_o
    rows["flash_bwd_dkv"]["max_abs_err"] = max(checks["dk"][1],
                                               checks["dv"][1])
    rows["flash_bwd_dq"]["max_abs_err"] = checks["dq"][1]
    del full, fdq, fdk, fdv, q, k, v, gr
    scale = d ** -0.5
    _, launch_dkv, launch_dq = A._flash_bwd_launchers(
        ql, kl, vl, bias, seed, out, lse, gl, False, 0, scale, p, h, r * hl)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (ql, kl, vl))
    gt = gl.transpose(1, 2)
    keep = (bias == 0)[:, None, None, :]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=keep)
    arms = {"fwd": lambda: A.flash_forward(ql, kl, vl, bias, seed, False,
                                           None, None, p, h, r * hl),
            "dkv": launch_dkv, "dq": launch_dq, "sdpa": sdpa,
            "sdpa_fb": lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), gt)}
    times = K4.graphs_ms({key: (lambda fn=fn: [fn() for _ in range(2)])
                          for key, fn in arms.items()}, 2)
    plain_f = time_ms(lambda: A.flash_forward_reference(
        ql, kl, vl, bias, seed, False, None, None, p, h, r * hl), iters=2,
        warmup=1)
    plain_b = time_ms(lambda: A.flash_backward_reference(
        ql, kl, vl, bias, seed, out, lse, gl, False, None, None, p, h,
        r * hl), iters=2, warmup=1)
    qkv = b * s * hl * d * 2
    product = 2 * b * hl * s * s * d
    rows_bytes = 2 * b * hl * s * 4 + b * s * 4
    for name, key, n_products, nbytes, plain, lib in (
            ("flash_fwd", "fwd", 2, 4 * qkv + b * s * 4 + b * hl * s * 4,
             plain_f, times["sdpa"]),
            ("flash_bwd_dkv", "dkv", 4, 6 * qkv + rows_bytes, plain_b,
             times["sdpa_fb"] - times["sdpa"]),
            ("flash_bwd_dq", "dq", 3, 5 * qkv + rows_bytes, plain_b,
             times["sdpa_fb"] - times["sdpa"])):
        bound_ms, bound_by = bound(n_products * product, nbytes)
        rows[name].update(
            ms=times[key], plain_ms=plain, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=lib,
            shape=f"q/k/v ({b},{s},{hl},{d}) bf16, heads {sl.start}-"
                  f"{sl.stop - 1} of {h}, key padding, dropout {p}")


def _tp_ffn(g, rows):
    """The FFN kernels on a tensor-parallel rank's d_ff columns: T=16384
    tokens, d_model 768, columns 1536-2303 of 3072 (rank 2 of mp 4),
    dropout 0.1: ffn_act against its plain version and bit for bit
    against the whole width's launch sliced, its mask bit for bit with
    `_ffn_keep` at the offset; ffn_fwd and both backward kernels against
    their plain versions at the offset; then each timed at that shape."""
    t, hid, ff, mp, r, p, seed = 32 * SEQ, 768, 3072, 4, 2, SPMD_DROPOUT, 21
    fl = ff // mp
    off = r * fl
    cs = slice(off, off + fl)
    pre_w, dh_w = _rand(g, t, ff, scale=2.0), _rand(g, t, ff)
    b1_w = _rand(g, ff, scale=0.1)
    h_w = F.ffn_act_fwd(pre_w, b1_w, "gelu", p, seed)
    dpre_w, _ = F.ffn_act_bwd(pre_w, b1_w, dh_w, "gelu", p, seed)
    pre, dh, b1 = (pre_w[:, cs].contiguous(), dh_w[:, cs].contiguous(),
                   b1_w[cs].contiguous())
    del pre_w, dh_w
    h = F.ffn_act_fwd(pre, b1, "gelu", p, seed, off)
    dpre, h2 = F.ffn_act_bwd(pre, b1, dh, "gelu", p, seed, off)
    torch.cuda.synchronize()
    ok_h, err_h = close(h, F.ffn_act_fwd_reference(pre, b1, "gelu", p, seed,
                                                   off), **ACT_TOL[torch.bfloat16])
    ok_d, err_d = close(dpre, F.ffn_act_bwd_reference(
        pre, b1, dh, "gelu", p, seed, off)[0], **ACT_TOL[torch.bfloat16])
    same = torch.equal(h, h_w[:, cs]) and torch.equal(dpre, dpre_w[:, cs]) \
        and torch.equal(h, h2)
    del h_w, dpre_w
    three = torch.full_like(pre, 3.0)
    zero = torch.zeros_like(b1)
    keep = F._ffn_keep(seed, 0, off, t, fl, p, device=pre.device)
    mask = torch.equal(F.ffn_act_fwd(three, zero, "relu", p, seed, off) != 0,
                       keep) and torch.equal(F.ffn_act_bwd(
                           three, zero, torch.ones_like(three), "relu", p,
                           seed, off)[0] != 0, keep)
    del three
    # the fused kernels (the kernel arm's) at the offset
    x = _rand(g, t, hid)
    w1, w2 = _rand(g, hid, fl, scale=0.03), _rand(g, fl, hid, scale=0.03)
    b2 = torch.zeros(hid, dtype=torch.bfloat16, device="cuda")
    go = _rand(g, t, hid)
    out = F.ffn_forward(x, w1, b1, w2, b2, "gelu", p, seed, off)
    out0 = F.ffn_forward(x, w1, b1, w2, b2, "gelu", p, seed)
    grads = F.ffn_backward(x, w1, b1, w2, b2, seed, go, "gelu", p, off)
    torch.cuda.synchronize()
    ok_f, err_f = close(out, F.ffn_forward_reference(
        x, w1, b1, w2, b2, "gelu", p, seed, off), **BF16_TOL)
    want = F.ffn_backward_reference(x, w1, b1, w2, b2, seed, go, "gelu", p,
                                    off)
    gchecks = {n: close_grad(a, w) for n, a, w in zip(
        ("dx", "dw1", "db1", "dw2", "db2"), grads, want)}
    moved = not torch.equal(out, out0)
    ok = ok_h and ok_d and same and mask and ok_f and moved and all(
        c[0] for c in gchecks.values())
    log(f"spmd ffn at columns {off}-{off + fl - 1} of {ff} (T={t}, p={p}): "
        f"ffn_act h err {err_h:.3g}, dpre err {err_d:.3g}, the whole "
        f"width's bits sliced {same}, mask bit for bit {mask}; ffn_fwd err "
        f"{err_f:.3g}, other bits than offset 0 {moved}; "
        + " ".join(f"{n} err {c[1]:.3g}" for n, c in gchecks.items())
        + f" {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError("the FFN kernels at a column offset")
    rows["ffn_act_fwd"]["max_abs_err"] = err_h
    rows["ffn_act_bwd"]["max_abs_err"] = err_d
    rows["ffn_fwd"]["max_abs_err"] = err_f
    rows["ffn_bwd_dw"]["max_abs_err"] = max(gchecks[n][1] for n in
                                            ("dw1", "db1", "dw2"))
    rows["ffn_bwd_dx"]["max_abs_err"] = gchecks["dx"][1]
    _, launch_dw, launch_dx = F._ffn_bwd_launchers(
        x, w1, b1, w2, b2, seed, go, "gelu", p, off)
    gelu, gelu_bw = torch.nn.functional.gelu, torch.ops.aten.gelu_backward

    def dw_arm():  # the library calls that compute dW1, dW2 and db1
        pre_ = torch.addmm(b1, x, w1)
        dpre_ = gelu_bw(go @ w2.t(), pre_)
        return x.t() @ dpre_, gelu(pre_).t() @ go, dpre_.sum(0)

    def dx_arm():  # ... and dx
        return gelu_bw(go @ w2.t(), torch.addmm(b1, x, w1)) @ w1.t()

    times = K4.graphs_ms({
        "act_fwd": lambda: [F.ffn_act_fwd(pre, b1, "gelu", p, seed, off)
                            for _ in range(4)],
        "act_bwd": lambda: [F.ffn_act_bwd(pre, b1, dh, "gelu", p, seed, off)
                            for _ in range(4)],
        "aten_bias_gelu": lambda: [gelu(pre + b1) for _ in range(4)],
        "fwd": lambda: [F.ffn_forward(x, w1, b1, w2, b2, "gelu", p, seed,
                                      off) for _ in range(4)],
        "dw": lambda: [launch_dw() for _ in range(4)],
        "dx": lambda: [launch_dx() for _ in range(4)],
        "library_fwd": lambda: [torch.addmm(b2, gelu(torch.addmm(b1, x, w1)),
                                            w2) for _ in range(4)],
        "library_dw": lambda: [dw_arm() for _ in range(4)],
        "library_dx": lambda: [dx_arm() for _ in range(4)]}, 4)
    plain = {
        "act_fwd": time_ms(lambda: F.ffn_act_fwd_reference(
            pre, b1, "gelu", p, seed, off), iters=2, warmup=1),
        "act_bwd": time_ms(lambda: F.ffn_act_bwd_reference(
            pre, b1, dh, "gelu", p, seed, off), iters=2, warmup=1),
        "fwd": time_ms(lambda: F.ffn_forward_reference(
            x, w1, b1, w2, b2, "gelu", p, seed, off), iters=2, warmup=1),
        "bwd": time_ms(lambda: F.ffn_backward_reference(
            x, w1, b1, w2, b2, seed, go, "gelu", p, off), iters=2,
            warmup=1)}
    # the counts of _ffn_backward_rows, at d_ff = fl
    mm = 2 * t * hid * fl
    act_bytes, weight_bytes = t * hid * 2, hid * fl * 2
    shape = (f"x ({t},{hid}) W1 ({hid},{fl}) W2 ({fl},{hid}) bf16, columns "
             f"{off}-{off + fl - 1} of {ff}, gelu, dropout {p}")
    for name, key, flops, nbytes, plain_ms, lib, shp in (
            ("ffn_act_fwd", "act_fwd", 0, (2 * t * fl + fl) * 2,
             plain["act_fwd"], None, f"pre ({t},{fl}) at column {off}"),
            ("ffn_act_bwd", "act_bwd", 0, (4 * t * fl + fl) * 2,
             plain["act_bwd"], None, f"pre/dh ({t},{fl}) at column {off}"),
            ("ffn_fwd", "fwd", 2 * mm,
             2 * act_bytes + 2 * weight_bytes + (fl + hid) * 2, plain["fwd"],
             times["library_fwd"], shape),
            ("ffn_bwd_dw", "dw", 4 * mm,
             2 * act_bytes + 4 * weight_bytes + 2 * fl * 2, plain["bwd"],
             times["library_dw"], shape),
            ("ffn_bwd_dx", "dx", 3 * mm,
             3 * act_bytes + 2 * weight_bytes + fl * 2, plain["bwd"],
             times["library_dx"], shape)):
        if flops:
            bound_ms, bound_by = bound(flops, nbytes)
        else:
            bound_ms, bound_by = nbytes / PEAK_BYTES * 1e3, "bytes"
        rows[name].update(ms=times[key], plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=lib, shape=shp)
    rows["ffn_act_fwd"]["aten_bias_gelu_ms"] = times["aten_bias_gelu"]


def _spmd_bert(world, rank, dev, axes, p, batch_size, one_process):
    """BERT-base's tensor-parallel step at full width on mesh `axes`
    ({dp, mp}), bf16 over f32 masters, dropout p: SPMD_STEPS steps on this
    rank's rows, the launch counters at 0 just before and read just
    after; the replicated tensors' bits the same on every rank; the
    masters gathered.  With `one_process` (rank 0) the one-process step on
    the whole batch from the same model, after."""
    from paddle_tpu_torch.convert import gather_shards
    from paddle_tpu_torch.parallel import mesh as M

    cfg = bert.BertConfig.base(hidden_dropout_prob=p,
                               attention_probs_dropout_prob=p)
    model = bert.BertForPretraining(cfg, seed=0)
    mesh = M.make_mesh(axes)
    step, state = bert.build_pretrain_step(model, mesh=mesh, dp_axis="dp",
                                           mp_axis="mp")
    one = bert.build_pretrain_step(model) if one_process else None
    del model
    fb = bert.fake_batch(cfg, batch_size, SEQ, num_masked=DIST_BERT_MASKED,
                         seed=11)
    mine = {k: torch.from_numpy(v).to(dev)
            for k, v in M.shard_host_batch(mesh, fb).items()}
    torch.cuda.synchronize()
    for c in COUNTERS.values():
        c.reset()
    # -- the main path: counters at 0 before, read right after --------------
    losses, step_ms = [], []
    for _ in range(SPMD_STEPS):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        state, loss = step(state, mine, TRAIN_LR)
        e1.record()
        torch.cuda.synchronize()
        step_ms.append(e0.elapsed_time(e1))
        losses.append(float(loss))
    launches = {n: c.value for n, c in COUNTERS.items()}
    # ------------------------------------------------------------------------
    _expect_launches(launches, LAYERS * SPMD_STEPS, TRAIN_KERNELS,
                     f"{SPMD_STEPS} tensor-parallel BERT steps")
    repl = [k for k in sorted(state["params"]) if not tuple(step.specs[k])]
    _same_on_every_rank(_fingerprint([state["params"][k] for k in repl]),
                        f"BERT {axes}: replicated masters")
    local = lambda part: sum(v.numel() * v.element_size()
                             for v in state[part].values())
    out = dict(axes=axes, dropout=p, losses=losses, step_ms=step_ms,
               launches=launches, rows=int(mine["input_ids"].shape[0]),
               param_bytes=local("params"),
               moment_bytes=local("m") + local("v"),
               split=sum(bool(tuple(s)) for s in step.specs.values()))
    masters = {k: gather_shards(state["params"][k], step.specs[k], mesh)
               for k in sorted(state["params"])}
    out["full_param_bytes"] = sum(a.nbytes for a in masters.values())
    del state, step, mine
    torch.cuda.empty_cache()
    if one is not None:
        step1, st1 = one
        batch = {k: torch.from_numpy(v).to(dev) for k, v in fb.items()}
        ref = []
        for _ in range(SPMD_STEPS):
            st1, loss = step1(st1, batch, TRAIN_LR)
            ref.append(float(loss))
        out["one_process"] = ref
        out["master_max_abs"] = max(
            float((torch.from_numpy(masters[k]).to(dev) - v).abs().max())
            for k, v in st1["params"].items())
        del st1, step1, batch
        torch.cuda.empty_cache()
    return out


def _spmd_resnet(world, rank, dev):
    """The static ResNet-50 of the dist phase (Momentum 0.1 with L2Decay,
    the global batch DIST_RESNET_BATCH at 224^2, f32): Fleet's plain
    collective run (each rank fed its rows); Fleet's sharding strategy at
    stages 1 and 3 (the SPMD arm on {data: ranks}, fed the global batch);
    BuildStrategy.mesh_axes {data: 1, fsdp: 2, tp: 2} (or {data: 1,
    fsdp: 2} on two ranks), and the same mesh with every spec overridden
    to P(): its replicated data-parallel twin over the same rows."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.parallel import spec_layout

    x, y = _dist_resnet_batch()
    k = DIST_RESNET_BATCH // world
    whole = {"image": torch.from_numpy(x).to(dev),
             "label": torch.from_numpy(y).to(dev)}
    mine = {n: v[rank * k:(rank + 1) * k] for n, v in whole.items()}
    axes = {"data": 1, "fsdp": 2, "tp": 2} if world == 4 else \
        {"data": 1, "fsdp": 2}

    def run(stage=None, mesh_axes=None, replicate=False, quant=False):
        opt = fluid.optimizer.Momentum(
            learning_rate=0.1, momentum=0.9,
            regularization=fluid.regularizer.L2Decay(1e-4))
        if mesh_axes is None:
            st = fleet.DistributedStrategy()
            if stage is not None:
                st.sharding = True
                st.sharding_configs = {"stage": stage}
            fleet.init(is_collective=True, strategy=st)
            opt = fleet.distributed_optimizer(opt, st)
        main, startup, fetches = _dist_resnet_program(opt)
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        if replicate:
            for n in scope.local_var_names():
                spec_layout.register_spec(n, spec_layout.P())
        bs = fluid.BuildStrategy()
        bs.mesh_axes = mesh_axes
        prog = fluid.CompiledProgram(main, bs).with_data_parallel(
            loss_name=fetches[0].name)
        feed = mine if (stage is None and mesh_axes is None) else whole
        losses, host_ms = [], []
        _quant_env(quant)
        before = profiler.get_int_stats()
        try:
            for _ in range(SPMD_RESNET_STEPS):
                h0 = time.perf_counter()
                (loss, _) = exe.run(prog, feed=feed, fetch_list=fetches,
                                    scope=scope)
                host_ms.append((time.perf_counter() - h0) * 1e3)
                losses.append(float(np.asarray(loss).reshape(-1)[0]))
        finally:
            spec_layout.clear_specs()
            _quant_env(False)
        after = profiler.get_int_stats()
        fc = next(p.name for p in main.all_parameters()
                  if p.name.startswith("fc") and len(p.shape) == 2)
        acc = [n for n in scope.local_var_names() if "_velocity" in n]
        out = dict(losses=losses, host_step_ms=host_ms,
                   acc_bytes=sum(scope.get(n).numel()
                                 * scope.get(n).element_size() for n in acc),
                   fc=fc, fc_shape=list(scope.get(fc).shape),
                   fc_full=list(main.global_block().var(fc).shape),
                   fc_velocity_shape=list(scope.get(
                       fc + "_velocity_0").shape),
                   # the gradients' traffic (the forward's gathers of
                   # sharded weights stay full width)
                   spmd_bytes={k: after[k] - before.get(k, 0) for k in after
                               if k.startswith("collective_bytes_spmd_")
                               and k.endswith(("all_reduce",
                                               "reduce_scatter"))})
        if not all(np.isfinite(losses)):
            raise AssertionError(f"resnet losses {losses}")
        del exe, scope
        torch.cuda.empty_cache()
        return out

    runs = {"plain": run(), "stage1": run(stage=1), "stage3": run(stage=3),
            "mesh": run(mesh_axes=axes),
            "mesh_replicated": run(mesh_axes=axes, replicate=True)}
    # int8 over the batch axes alone ({data: 1, fsdp: ranks}): the tp
    # axis's average of its ranks' copies stays full width
    fsdp = {"data": 1, "fsdp": world}
    runs["fsdp"] = runs["mesh"] if fsdp == axes else run(mesh_axes=fsdp)
    runs["fsdp_int8"] = run(mesh_axes=fsdp, quant=True)
    _quant_health("resnet fsdp int8", runs["fsdp_int8"], runs["fsdp"],
                  "spmd_bytes")
    for tag, base in (("stage1", "plain"), ("stage3", "plain"),
                      ("mesh", "mesh_replicated")):
        got, want = np.array(runs[tag]["losses"]), np.array(
            runs[base]["losses"])
        rel = np.abs(got - want) / np.abs(want)
        runs[tag]["rel_err"] = rel.tolist()
        if rel.max() > SPMD_RESNET_RTOL:
            raise AssertionError(f"resnet {tag} rank {rank}: losses {got} "
                                 f"against {base}'s {want}")
    for tag in ("stage1", "stage3"):
        share = runs[tag]["acc_bytes"] * world
        if share != runs["plain"]["acc_bytes"]:
            raise AssertionError(f"resnet {tag}: {runs[tag]['acc_bytes']} "
                                 f"accumulator bytes a rank")
    m = runs["mesh"]
    want = [m["fc_full"][0] // 2, m["fc_full"][1] // axes.get("tp", 1)]
    if m["fc_shape"] != want or m["fc_velocity_shape"] != want:
        raise AssertionError(f"resnet mesh: the fc weight {m['fc_shape']} "
                             f"and its velocity {m['fc_velocity_shape']}")
    runs["mesh_axes"] = axes
    return runs


SPMD_CKPT_STEPS, SPMD_CKPT_PREEMPT = 4, 2


def _spmd_ckpt(world, rank, workdir):
    """A sharded checkpoint on the SPMD arm: the tiny transformer of
    tests/torch_dist_worker.py over {data: 1, fsdp: ranks} through
    train_from_dataset with a checkpoint a step (every rank writes the
    vars dealt to it, the fsdp-split ones gathered whole, host 0
    commits): one pass whole, one stopped after step SPMD_CKPT_PREEMPT
    (an exception from step_callback on every rank), a fresh Executor,
    scope and CompiledProgram resuming it.  The resumed run's losses,
    parameters and moments must be the uninterrupted run's bits."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import torch_dist_worker as TW

    from paddle_tpu_torch import convert, fluid

    files = TW.ckpt_files(os.path.join(workdir, f"ckpt_data.{rank}"),
                          n_files=2 * world, lines=16)
    axes = {"data": 1, "fsdp": world}

    def run(ckpt, preempt_at=None):
        main, startup, loss = TW.tiny_program(fluid, unique_name)
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        bs = fluid.BuildStrategy()
        bs.mesh_axes = axes
        prog = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, build_strategy=bs)
        ds = fluid.DatasetFactory().create_dataset("InMemoryDataset")
        ds.set_batch_size(8)
        ds.set_use_var([main.global_block().var("ids"),
                        main.global_block().var("label")])
        ds.set_filelist(files)
        ds.load_into_memory()
        losses = {}

        def cb(step, k, outs):
            losses[k] = float(np.asarray(outs[0]).reshape(-1)[0])
            if k == preempt_at:
                raise KeyboardInterrupt("preempted")

        try:
            exe.train_from_dataset(prog, ds, scope=scope, fetch_list=[loss],
                                   checkpoint_dir=ckpt,
                                   checkpoint_every_steps=1,
                                   checkpoint_keep=10, step_callback=cb)
        except KeyboardInterrupt:
            pass
        return losses, convert.gather_sharded_scope(scope, main, prog._mesh)

    root = os.path.join(workdir, "ckpt_spmd")
    before = profiler.get_int_stats()
    t_before = profiler.get_time_stats()
    whole, wfull = run(os.path.join(root, "whole"))
    saves = profiler.get_int_stats().get("ckpt_saves_total", 0) \
        - before.get("ckpt_saves_total", 0)
    t_after = profiler.get_time_stats()
    part, _ = run(os.path.join(root, "cut"), SPMD_CKPT_PREEMPT)
    rest, rfull = run(os.path.join(root, "cut"))
    same = sorted(wfull) == sorted(rfull) and all(
        np.array_equal(wfull[n], rfull[n]) for n in wfull)
    steps = list(range(1, SPMD_CKPT_STEPS + 1))
    ok = (sorted(whole) == steps and sorted(rest) == steps[SPMD_CKPT_PREEMPT:]
          and all(rest[k] == whole[k] for k in rest)
          and all(part[k] == whole[k] for k in part) and same)
    cut = os.path.join(root, "cut")
    last = os.path.join(cut, sorted(d for d in os.listdir(cut)
                                    if d.startswith("ckpt-"))[-1])
    sizes = {f: os.path.getsize(os.path.join(last, f))
             for f in os.listdir(last) if f.startswith("shard_")}
    manifest = json.load(open(os.path.join(last, "manifest.json")))
    out = dict(mesh=axes, whole=whole, part=part, rest=rest, same_bits=same,
               saves=saves, shard_bytes=sizes.get(
                   f"shard_{rank:05d}.npz", 0),
               total_bytes=sum(sizes.values()),
               writer_ms=(t_after.get("ckpt_save_ms", 0.0)
                          - t_before.get("ckpt_save_ms", 0.0))
               / max(saves, 1),
               mesh_axes=manifest.get("mesh_axes"))
    if not ok or manifest.get("mesh_axes") != axes:
        raise AssertionError(f"spmd ckpt rank {rank}: {out}")
    return out


def spmd_rank(workdir, tag, parts):
    """One rank of the spmd phase (started by distributed.spawn), as
    dist_rank: writes what it measured to workdir/tag.RANK.json."""
    import paddle_tpu_torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    F.enable_fused_ffn()
    env = dist.init_parallel_env()
    dev = dist.parallel.device()
    rank, world = env.rank, env.world_size
    backend = dist.parallel.backend()
    out = dict(rank=rank, world=world, backend=backend, device=str(dev),
               card=card_line())
    t0 = time.perf_counter()
    batch = SPMD_BERT_BATCH[backend]
    if "bert" in parts:
        out["bert"] = _spmd_bert(world, rank, dev, {"dp": 1, "mp": world},
                                 SPMD_DROPOUT, batch, rank == 0)
    if "bert_dp_mp" in parts:
        out["bert_dp_mp"] = _spmd_bert(world, rank, dev, {"dp": 2, "mp": 2},
                                       0.0, batch, rank == 0)
    if "resnet" in parts:
        out["resnet"] = _spmd_resnet(world, rank, dev)
    if "ckpt" in parts:
        out["ckpt"] = _spmd_ckpt(world, rank, workdir)
    out["rank_s"] = time.perf_counter() - t0
    with open(os.path.join(workdir, f"{tag}.{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_parallel_env()


@phase("spmd")
def spmd():
    """Phase 29: model parallelism.  The kernels at a tensor-parallel
    rank's head and column offsets against their plain versions (and,
    bit for bit, the whole width's launch sliced), timed at those shapes;
    then ranks started by distributed.spawn: BERT-base's tensor-parallel
    step on {dp: 1, mp: ranks} at dropout 0.1 (and, with four ranks,
    {dp: 2, mp: 2} at dropout 0) against the one-process step, and the
    static ResNet-50 through Fleet's sharding (stages 1 and 3) and
    BuildStrategy.mesh_axes.  Returns (rank 0's launches of the
    {dp: 1, mp: ranks} run, the kernels' rows at the tensor-parallel
    shapes)."""
    import importlib

    import paddle_tpu_torch.distributed as dist_mod

    g = torch.Generator().manual_seed(29)
    tp_rows = {n: {} for n in TRAIN_KERNELS + ACT_KERNELS}
    _tp_flash(g, tp_rows)
    torch.cuda.empty_cache()
    _tp_ffn(g, tp_rows)
    torch.cuda.empty_cache()
    for name, r in tp_rows.items():
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f}"
        log(f"spmd {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
            f"library {lib}, bound {r['bound_ms']:.4f} {r['bound_by']}) at "
            f"{r['shape']}")
    cards = torch.cuda.device_count()
    card = card_line()
    rank_fn = importlib.import_module("chip_smoke").spmd_rank
    root = str(Path(__file__).resolve().parent)
    work = tempfile.mkdtemp(prefix="spmd_")
    launches, results = None, {}
    try:
        for backend, n, gpus in _spmd_plan(cards):
            tag = f"{backend}{n}"
            parts = ("bert", "resnet", "ckpt") + (("bert_dp_mp",) if n == 4
                                                  else ())
            env = {"PADDLE_DISTRI_BACKEND": backend,
                   "PYTHONPATH": os.pathsep.join(
                       [root] + [p for p in os.environ.get(
                           "PYTHONPATH", "").split(os.pathsep) if p])}
            t0 = time.perf_counter()
            dist_mod.spawn(rank_fn, args=(work, tag, parts), nprocs=n,
                           gpus=gpus, env=env)
            wall = time.perf_counter() - t0
            runs = [json.load(open(os.path.join(work, f"{tag}.{r}.json")))
                    for r in range(n)]
            results[tag] = runs
            log(f"spmd {tag}: backend {backend}, world {n}, cards {gpus} "
                f"({cards} on the host); spawn to exit {wall:.1f} s; ranks "
                f"{[round(r['rank_s'], 1) for r in runs]} s of work")
            for key in ("bert", "bert_dp_mp"):
                if key not in runs[0]:
                    continue
                b = [r[key] for r in runs]
                launches = launches if key != "bert" else b[0]["launches"]
                got = np.mean([x["losses"] for x in b], axis=0) \
                    if key == "bert_dp_mp" else np.array(b[0]["losses"])
                want = np.array(b[0]["one_process"])
                rel = np.abs(got - want) / np.abs(want)
                for r, x in enumerate(b):
                    log(f"spmd {tag} rank {r}: BERT-base {x['axes']} "
                        f"dropout {x['dropout']} B={x['rows']} S={SEQ}: "
                        f"losses {x['losses']}; step ms (CUDA events) "
                        f"{[round(v, 3) for v in x['step_ms']]} (min "
                        f"{min(x['step_ms']):.3f}, max "
                        f"{max(x['step_ms']):.3f}); param bytes "
                        f"{x['param_bytes']} of {x['full_param_bytes']}, "
                        f"moment bytes {x['moment_bytes']}; {x['split']} "
                        f"tensors split; launches {x['launches']}")
                log(f"spmd {tag}: BERT-base {b[0]['axes']} losses "
                    f"{got.tolist()} against one process {want.tolist()}: "
                    f"rel err {rel.tolist()} (rtol {SPMD_LOSS_RTOL}); "
                    f"gathered masters max abs diff "
                    f"{b[0]['master_max_abs']:.3g} (atol "
                    f"{SPMD_MASTER_ATOL:.3g})")
                if rel.max() > SPMD_LOSS_RTOL or \
                        b[0]["master_max_abs"] > SPMD_MASTER_ATOL:
                    raise AssertionError(f"{tag} {key}: the tensor-parallel "
                                         "step parts from one process")
            for r, x in enumerate(run["resnet"] for run in runs):
                log(f"spmd {tag} rank {r}: static ResNet-50 "
                    + "; ".join(
                        f"{t}: losses {x[t]['losses']}"
                        + (f" (rel err {x[t]['rel_err']})"
                           if "rel_err" in x[t] else "")
                        + f", accumulator bytes {x[t]['acc_bytes']}, host "
                        f"ms {[round(v, 1) for v in x[t]['host_step_ms']]}"
                        for t in ("plain", "stage1", "stage3", "mesh",
                                  "mesh_replicated", "fsdp", "fsdp_int8"))
                    + f"; mesh {x['mesh_axes']}: {x['mesh']['fc']} "
                    f"{x['mesh']['fc_shape']} of {x['mesh']['fc_full']}, "
                    f"its velocity {x['mesh']['fc_velocity_shape']}; "
                    f"FLAGS_quant_collectives=int8 on {{data: 1, fsdp: "
                    f"{len(runs)}}}: losses rel err against full width "
                    f"{x['fsdp_int8']['rel_err_full_width']} (bound "
                    f"{QUANT_HEALTH_RTOL}), gradient wire bytes "
                    f"{x['fsdp_int8']['spmd_bytes']} against "
                    f"{x['fsdp']['spmd_bytes']} "
                    f"({x['fsdp_int8']['wire_drop']:.2f}x fewer)")
            for r, x in enumerate(run["ckpt"] for run in runs):
                log(f"spmd {tag} rank {r}: sharded checkpoint of the tiny "
                    f"transformer on the SPMD arm {x['mesh']}: losses "
                    f"{x['whole']} uninterrupted, {x['part']} then "
                    f"{x['rest']} stopped after step {SPMD_CKPT_PREEMPT} "
                    f"and resumed; the resumed parameters and moments the "
                    f"uninterrupted run's bits {x['same_bits']}; "
                    f"{x['saves']} saves, writer ms a save "
                    f"{x['writer_ms']:.3f}, bytes a rank a save "
                    f"{x['shard_bytes']} (of {x['total_bytes']})")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("spmd summary: " + json.dumps(dict(card=card, cards=cards,
                                           kernels=tp_rows, runs=results),
                                      default=str))
    return launches, tp_rows


# -- sequence parallelism over torch.distributed (phase 30) ----------------------

# the ranks as the spmd phase's: one NCCL group of 4 with four cards, else
# two gloo ranks sharing card 0; BERT-base at full width, B=32, S=512,
# hidden dropout 0.1 and attention dropout 0 (ring and Ulysses refuse it)
SEQ_STEPS = 2
SEQ_BATCH = 32
SEQ_DROPOUT = 0.1
SEQ_MODES = ("ring", "ulysses")
# the sequence-parallel step (bf16 forward) against one process's on the
# same batch and seed: the loss, relative, every step (the ring merges
# bf16 block outputs by their LSE, where one process runs one launch over
# the keys); and per master leaf, |sp - one process| over |one process's
# update| (the drift).  A planted fault, rank-local hidden dropout masks
# (each rank draws the mask of its own tokens' shape, not the whole
# batch's slice) on the Ulysses step, must exceed both limits.  They sit
# between the readings on NVIDIA H100 80GB HBM3 cards (700 W; PERF.md),
# two gloo ranks on one / four NCCL ranks: sound loss rel err at most
# 3.1e-4 / 3.1e-4 (ring), drift 0.19 / 0.18 (ring); the planted fault's
# loss 3.8e-3 / 1.2e-2, drift 1.12 / 1.26
SEQ_LOSS_RTOL = 1e-3
SEQ_DRIFT_LIMIT = 0.5


def _sp_flash(g, n, rows):
    """The flash kernels at the sequence-parallel shapes of n ranks
    (BERT-base, B=32, S=512): ring blocks q/k/v (32, 512/n, 12, 64) and
    Ulysses' head groups (32, 512, 12/n, 64) with key padding, dropout 0.
    Held against the plain versions: a visiting block at offset 0 (the
    launch of each ring step) and one launch over the whole keys, O and
    LSE; the last rank's n blocks merged by their LSE (`merge_blocks`)
    against that whole launch; the diagonal block in the kernel's causal
    mode; a visiting block's
    and the diagonal block's backward against the final O and LSE; the
    skipped blocks of a causal ring counted by its plan; Ulysses'
    forward and backward.  Then each timed, beside SDPA at that shape."""
    from paddle_tpu_torch.parallel.ring_attention import (_blocks,
                                                          merge_blocks)

    b, s, h, d = 32, SEQ, 12, 64
    sl, hl, r, scale = s // n, h // n, n - 1, d ** -0.5
    q, k, v, gr = (_rand(g, b, s, h, d) for _ in range(4))
    blk = lambda x, j: x[:, j * sl:(j + 1) * sl].contiguous()
    qr, gq = blk(q, r), blk(gr, r)
    whole, whole_lse = A.flash_forward(qr, k, v, None, 0, False, None, scale)
    acc = lse = None
    for j in range(n):
        acc, lse = merge_blocks(acc, lse, *A.flash_forward(
            qr, blk(k, j), blk(v, j), None, 0, False, 0, scale))
    merged = acc.to(q.dtype)
    kr, vr, k0, v0 = blk(k, r), blk(v, r), blk(k, 0), blk(v, 0)
    # the launch each ring step makes: a visiting block at offset 0
    ov, lv = A.flash_forward(qr, k0, v0, None, 0, False, 0, scale)
    od, ld = A.flash_forward(qr, kr, vr, None, 0, True, 0, scale)
    g0 = A.flash_backward(qr, k0, v0, None, 0, merged, lse, gq, False, 0,
                          scale)
    gd = A.flash_backward(qr, kr, vr, None, 0, merged, lse, gq, True, 0,
                          scale)
    qu, ku, vu, gu = (x[:, :, :hl].contiguous() for x in (q, k, v, gr))
    bias = _padding_bias(g, b, s)
    ou, lu = A.flash_forward(qu, ku, vu, bias, 0, False, None, scale)
    guly = A.flash_backward(qu, ku, vu, bias, 0, ou, lu, gu, False, None,
                            scale)
    torch.cuda.synchronize()
    ref_ov, ref_lv = A.flash_forward_reference(qr, k0, v0, None, 0, False, 0,
                                               scale)
    ref_whole, ref_whole_lse = A.flash_forward_reference(
        qr, k, v, None, 0, False, None, scale)
    ref_od, ref_ld = A.flash_forward_reference(qr, kr, vr, None, 0, True, 0,
                                               scale)
    ref_g0 = A.flash_backward_reference(qr, k0, v0, None, 0, merged, lse, gq,
                                        False, 0, scale)
    ref_gd = A.flash_backward_reference(qr, kr, vr, None, 0, merged, lse, gq,
                                        True, 0, scale)
    ref_ou, ref_lu = A.flash_forward_reference(qu, ku, vu, bias, 0, False,
                                               None, scale)
    ref_gu = A.flash_backward_reference(qu, ku, vu, bias, 0, ou, lu, gu,
                                        False, None, scale)
    checks = {
        "visiting O": close(ov, ref_ov, **BF16_TOL),
        "visiting LSE": close(lv, ref_lv, **LSE_TOL),
        "whole O": close(whole, ref_whole, **BF16_TOL),
        "whole LSE": close(whole_lse, ref_whole_lse, **LSE_TOL),
        "merge O": close(merged, whole, **BF16_TOL),
        "merge LSE": close(lse, whole_lse, **LSE_TOL),
        "diagonal O": close(od, ref_od, **BF16_TOL),
        "diagonal LSE": close(ld, ref_ld, **LSE_TOL),
        "ulysses O": close(ou, ref_ou, **BF16_TOL),
        "ulysses LSE": close(lu, ref_lu, **LSE_TOL)}
    for tag, got, want in (("visiting", g0, ref_g0), ("diagonal", gd, ref_gd),
                           ("ulysses", guly, ref_gu)):
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            checks[f"{tag} {name}"] = close_grad(a, w)
    # a causal ring launches rank j's first j + 1 blocks and skips the rest
    plan = [len(list(_blocks(n, j, True))) for j in range(n)]
    checks["causal plan"] = (plan == list(range(1, n + 1)), 0.0)
    ok = all(c[0] for c in checks.values())
    log(f"seq flash at {n} ranks: " + "; ".join(
        f"{k} err {v[1]:.3g}" for k, v in checks.items())
        + f"; causal ring blocks launched by rank {plan} of {n} "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError("the flash kernels at the sequence-parallel "
                             "shapes")
    _, dkv_ring, dq_ring = A._flash_bwd_launchers(
        qr, k0, v0, None, 0, merged, lse, gq, False, 0, scale, 0.0)
    _, dkv_uly, dq_uly = A._flash_bwd_launchers(
        qu, ku, vu, bias, 0, ou, lu, gu, False, 0, scale, 0.0)
    keep = (bias == 0)[:, None, None, :]

    def sdpa_arms(qq, kk, vv, gg, mask):
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (qq, kk, vv))
        f = lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask)
        return f, lambda: torch.autograd.grad(f(), (qt, kt, vt),
                                              gg.transpose(1, 2))

    ring_sdpa, ring_sdpa_fb = sdpa_arms(qr, k0, v0, gq, None)
    uly_sdpa, uly_sdpa_fb = sdpa_arms(qu, ku, vu, gu, keep)
    arms = {"ring_fwd": lambda: A.flash_forward(qr, k0, v0, None, 0, False,
                                                0, scale),
            "ring_dkv": dkv_ring, "ring_dq": dq_ring,
            "ring_sdpa": ring_sdpa, "ring_sdpa_fb": ring_sdpa_fb,
            "uly_fwd": lambda: A.flash_forward(qu, ku, vu, bias, 0, False,
                                               None, scale),
            "uly_dkv": dkv_uly, "uly_dq": dq_uly,
            "uly_sdpa": uly_sdpa, "uly_sdpa_fb": uly_sdpa_fb}
    times = K4.graphs_ms({key: (lambda fn=fn: [fn() for _ in range(2)])
                          for key, fn in arms.items()}, 2)
    plain = {
        "ring_fwd": time_ms(lambda: A.flash_forward_reference(
            qr, k0, v0, None, 0, False, 0, scale), iters=2, warmup=1),
        "ring_bwd": time_ms(lambda: A.flash_backward_reference(
            qr, k0, v0, None, 0, merged, lse, gq, False, 0, scale), iters=2,
            warmup=1),
        "uly_fwd": time_ms(lambda: A.flash_forward_reference(
            qu, ku, vu, bias, 0, False, None, scale), iters=2, warmup=1),
        "uly_bwd": time_ms(lambda: A.flash_backward_reference(
            qu, ku, vu, bias, 0, ou, lu, gu, False, None, scale), iters=2,
            warmup=1)}
    errs = {("ring", "flash_fwd"): ("visiting O", "diagonal O"),
            ("ring", "flash_bwd_dkv"): ("visiting dk", "visiting dv",
                                        "diagonal dk", "diagonal dv"),
            ("ring", "flash_bwd_dq"): ("visiting dq", "diagonal dq"),
            ("ulysses", "flash_fwd"): ("ulysses O",),
            ("ulysses", "flash_bwd_dkv"): ("ulysses dk", "ulysses dv"),
            ("ulysses", "flash_bwd_dq"): ("ulysses dq",)}
    for mode, tag, sk, heads, kb in (("ring", "ring", sl, h, 0),
                                     ("ulysses", "uly", s, hl, 1)):
        sq = sl if mode == "ring" else s
        qb = b * sq * heads * d * 2
        kvb = b * sk * heads * d * 2
        product = 2 * b * heads * sq * sk * d
        rows_bytes = 2 * b * heads * sq * 4 + kb * b * sk * 4
        shape = (f"q ({b},{sq},{heads},{d}) k/v ({b},{sk},{heads},{d}) "
                 f"bf16" + (", key padding" if kb else "")
                 + f", {n} ranks")
        lib_b = times[f"{tag}_sdpa_fb"] - times[f"{tag}_sdpa"]
        for name, key, n_products, nbytes, plain_ms, lib in (
                ("flash_fwd", "fwd", 2, 2 * qb + 2 * kvb + kb * b * sk * 4
                 + b * heads * sq * 4, plain[f"{tag}_fwd"],
                 times[f"{tag}_sdpa"]),
                ("flash_bwd_dkv", "dkv", 4, 2 * qb + 4 * kvb + rows_bytes,
                 plain[f"{tag}_bwd"], lib_b),
                ("flash_bwd_dq", "dq", 3, 3 * qb + 2 * kvb + rows_bytes,
                 plain[f"{tag}_bwd"], lib_b)):
            bound_ms, bound_by = bound(n_products * product, nbytes)
            rows[name][mode] = dict(
                ms=times[f"{tag}_{key}"], plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib,
                shape=shape, max_abs_err=max(
                    checks[c][1] for c in errs[mode, name]))


def _sp_ffn(g, n, rows):
    """The FFN kernels on a sequence rank's tokens (the last of n): x
    (32 * 512/n, 768), d_ff 3072, dropout 0.1, the hash's row map
    (period 512/n, stride 512, offset the rank's first token): ffn_act's
    masks the whole batch's sliced bit for bit, ffn_fwd and both
    backward kernels against their plain versions under the map (and
    other bits than without it); then timed at that shape."""
    b, hid, ff, p, seed = 32, 768, 3072, SEQ_DROPOUT, 33
    sl = SEQ // n
    t, rmap = b * sl, (sl, SEQ, (n - 1) * sl)
    pre_w, b1 = _rand(g, b * SEQ, ff, scale=2.0), _rand(g, ff, scale=0.1)
    h_w = F.ffn_act_fwd(pre_w, b1, "gelu", p, seed)
    mine = lambda x: x.view(b, SEQ, -1)[:, rmap[2]:rmap[2] + sl].reshape(
        t, -1).contiguous()
    pre = mine(pre_w)
    h = F.ffn_act_fwd(pre, b1, "gelu", p, seed, 0, rmap)
    torch.cuda.synchronize()
    same = torch.equal(h, mine(h_w))
    del pre_w, h_w
    x = _rand(g, t, hid)
    w1, w2 = _rand(g, hid, ff, scale=0.03), _rand(g, ff, hid, scale=0.03)
    b2 = torch.zeros(hid, dtype=torch.bfloat16, device="cuda")
    go = _rand(g, t, hid)
    out = F.ffn_forward(x, w1, b1, w2, b2, "gelu", p, seed, 0, rmap)
    out0 = F.ffn_forward(x, w1, b1, w2, b2, "gelu", p, seed)
    grads = F.ffn_backward(x, w1, b1, w2, b2, seed, go, "gelu", p, 0, rmap)
    torch.cuda.synchronize()
    ok_f, err_f = close(out, F.ffn_forward_reference(
        x, w1, b1, w2, b2, "gelu", p, seed, 0, *rmap), **BF16_TOL)
    want = F.ffn_backward_reference(x, w1, b1, w2, b2, seed, go, "gelu", p,
                                    0, rmap)
    gchecks = {k: close_grad(a, w_) for k, a, w_ in zip(
        ("dx", "dw1", "db1", "dw2", "db2"), grads, want)}
    moved = not torch.equal(out, out0)
    ok = same and ok_f and moved and all(c[0] for c in gchecks.values())
    log(f"seq ffn at the last of {n} sequence ranks (T={t}, row map "
        f"{rmap}, p={p}): ffn_act's bits the whole batch's sliced {same}; "
        f"ffn_fwd err {err_f:.3g}, other bits than no map {moved}; "
        + " ".join(f"{k} err {c[1]:.3g}" for k, c in gchecks.items())
        + f" {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError("the FFN kernels under a sequence row map")
    _, launch_dw, launch_dx = F._ffn_bwd_launchers(
        x, w1, b1, w2, b2, seed, go, "gelu", p, 0, rmap)
    gelu = torch.nn.functional.gelu
    times = K4.graphs_ms({
        "fwd": lambda: [F.ffn_forward(x, w1, b1, w2, b2, "gelu", p, seed, 0,
                                      rmap) for _ in range(2)],
        "dw": lambda: [launch_dw() for _ in range(2)],
        "dx": lambda: [launch_dx() for _ in range(2)],
        "library_fwd": lambda: [torch.addmm(b2, gelu(torch.addmm(b1, x, w1)),
                                            w2) for _ in range(2)]}, 2)
    plain_f = time_ms(lambda: F.ffn_forward_reference(
        x, w1, b1, w2, b2, "gelu", p, seed, 0, *rmap), iters=2, warmup=1)
    plain_b = time_ms(lambda: F.ffn_backward_reference(
        x, w1, b1, w2, b2, seed, go, "gelu", p, 0, rmap), iters=2, warmup=1)
    mm = 2 * t * hid * ff
    act_bytes, weight_bytes = t * hid * 2, hid * ff * 2
    shape = (f"x ({t},{hid}) W1 ({hid},{ff}) W2 ({ff},{hid}) bf16, the last "
             f"of {n} sequence ranks' tokens, gelu, dropout {p}")
    for name, key, flops, nbytes, plain_ms, lib, err in (
            ("ffn_fwd", "fwd", 2 * mm,
             2 * act_bytes + 2 * weight_bytes + (ff + hid) * 2, plain_f,
             times["library_fwd"], err_f),
            ("ffn_bwd_dw", "dw", 4 * mm,
             2 * act_bytes + 4 * weight_bytes + 2 * ff * 2, plain_b, None,
             max(gchecks[k][1] for k in ("dw1", "db1", "dw2"))),
            ("ffn_bwd_dx", "dx", 3 * mm,
             3 * act_bytes + 2 * weight_bytes + ff * 2, plain_b, None,
             gchecks["dx"][1])):
        bound_ms, bound_by = bound(flops, nbytes)
        rows[name]["sequence"] = dict(
            ms=times[key], plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=lib, shape=shape, max_abs_err=err)


# leaves whose gradient is 0 in exact arithmetic (a key bias adds the
# same score to every key of a row, and the softmax drops it): their
# update is rounding noise that AdamW scales to the learning rate
SEQ_DRIFT_EXEMPT = ("self_attn.k_proj.bias",)


def _master_drift(got, want, init):
    """Per master leaf, |got - want| over |want - init| (Frobenius): how
    far a run's masters stand from one process's, against how far one
    process's moved.  Returns (the largest over the leaves not in
    SEQ_DRIFT_EXEMPT, its leaf, the median over every leaf)."""
    drift = {}
    for k, w in want.items():
        moved = float((w - init[k]).norm())
        off = float((got[k] - w).norm())
        drift[k] = off / moved if moved else (0.0 if off == 0 else
                                              float("inf"))
    held = {k: v for k, v in drift.items()
            if not k.endswith(SEQ_DRIFT_EXEMPT)}
    worst = max(held, key=held.get)
    return held[worst], worst, float(np.median(list(drift.values())))


class _rank_local_masks:
    """The planted fault of the seq phase's control run: every dropout
    draws the mask of the rank's own tokens' shape, as if the rank's
    tokens were the whole sequence (F.dropout's sequence slice undone)."""

    def __enter__(self):
        self.body = pF._dropout_body
        pF._dropout_body = lambda x, p, training, upscale, gen, seq=None: \
            self.body(x, p, training, upscale, gen, None)

    def __exit__(self, *exc):
        pF._dropout_body = self.body


def _seq_bert(world, rank, dev, mode, one_process, control=False):
    """BERT-base's sequence-parallel step at full width on {dp: 1, sp:
    ranks} with `mode` attention (ring: the batch's rows unpadded), bf16
    over f32 masters, hidden dropout SEQ_DROPOUT: SEQ_STEPS steps on this
    rank's tokens, the launch counters at 0 just before and read just
    after; the masters' bits the same on every rank.  With `control`,
    then the same steps again from the start with the planted fault
    (`_rank_local_masks`).  With `one_process` (rank 0) the one-process
    step on the whole batch, after, and each run's losses and master
    drift against it."""
    from paddle_tpu_torch.parallel import mesh as M

    cfg = bert.BertConfig.base(hidden_dropout_prob=SEQ_DROPOUT,
                               attention_probs_dropout_prob=0.0)
    model = bert.BertForPretraining(cfg, seed=0)
    mesh = M.make_mesh({"dp": 1, "sp": world})
    build = lambda: bert.build_pretrain_step(
        model, mesh=mesh, dp_axis="dp", sp_axis="sp",
        use_ring_attention=mode == "ring", use_ulysses=mode == "ulysses")
    step, state = build()
    init = {k: v.clone() for k, v in state["params"].items()} \
        if one_process else None
    fb = bert.fake_batch(cfg, SEQ_BATCH, SEQ, num_masked=DIST_BERT_MASKED,
                         seed=11)
    if mode == "ring":
        fb["attention_mask"][:] = 1
    mine = {k: torch.from_numpy(v).to(dev) for k, v in M.shard_host_batch(
        mesh, fb, seq_keys=bert.SEQ_KEYS).items()}
    torch.cuda.synchronize()
    before = profiler.get_int_stats()
    for c in COUNTERS.values():
        c.reset()
    # -- the main path: counters at 0 before, read right after --------------
    losses, step_ms = [], []
    for _ in range(SEQ_STEPS):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        state, loss = step(state, mine, TRAIN_LR)
        e1.record()
        torch.cuda.synchronize()
        step_ms.append(e0.elapsed_time(e1))
        losses.append(float(loss))
    launches = {k: c.value for k, c in COUNTERS.items()}
    # ------------------------------------------------------------------------
    after = profiler.get_int_stats()
    blocks = world if mode == "ring" else 1  # non-causal: every block
    want = {k: LAYERS * SEQ_STEPS * (blocks if k.startswith("flash") else 1)
            for k in TRAIN_KERNELS}
    got = {k: launches.get(k, 0) for k in want}
    others = {k: v for k, v in launches.items() if k not in want and v}
    if got != want or others:
        raise AssertionError(f"{mode}: launches {launches} (want {want})")
    _same_on_every_rank(_fingerprint([state["params"][k]
                                      for k in sorted(state["params"])]),
                        f"BERT sp {mode}: masters")
    moved = {k: (after.get(k, 0) - before.get(k, 0)) // SEQ_STEPS
             for k in ("seq_parallel_ring_bytes",
                       "seq_parallel_all_to_all_bytes")}
    out = dict(mode=mode, losses=losses, step_ms=step_ms, launches=launches,
               tokens=list(mine["input_ids"].shape), bytes_a_step=moved)
    runs = {"sound": (losses, state["params"])}
    del state, step
    if control:
        step, state = build()
        planted = []
        with _rank_local_masks():
            for _ in range(SEQ_STEPS):
                state, loss = step(state, mine, TRAIN_LR)
                planted.append(float(loss))
        runs["planted"] = (planted, state["params"])
        del state, step
    del mine
    if one_process:
        step1, st1 = bert.build_pretrain_step(model)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in fb.items()}
        ref = []
        for _ in range(SEQ_STEPS):
            st1, loss = step1(st1, batch, TRAIN_LR)
            ref.append(float(loss))
        out["one_process"] = ref
        for tag, (run_losses, masters) in runs.items():
            worst, leaf, median = _master_drift(masters, st1["params"], init)
            out[tag] = dict(losses=run_losses, loss_rel=max(
                abs(a - b) / abs(b) for a, b in zip(run_losses, ref)),
                drift=worst, drift_leaf=leaf, drift_median=median)
        del st1, step1, batch
    del runs, init, model
    torch.cuda.empty_cache()
    return out


def seq_rank(workdir, tag, parts):
    """One rank of the seq phase (started by distributed.spawn), as
    spmd_rank: writes what it measured to workdir/tag.RANK.json.  The
    last mode of `parts` also runs the planted-fault control."""
    import paddle_tpu_torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    F.enable_fused_ffn()
    env = dist.init_parallel_env()
    dev = dist.parallel.device()
    rank, world = env.rank, env.world_size
    out = dict(rank=rank, world=world, backend=dist.parallel.backend(),
               device=str(dev), card=card_line())
    t0 = time.perf_counter()
    for mode in parts:
        out[mode] = _seq_bert(world, rank, dev, mode, rank == 0,
                              control=mode == parts[-1])
    out["rank_s"] = time.perf_counter() - t0
    with open(os.path.join(workdir, f"{tag}.{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_parallel_env()


@phase("seq")
def seq():
    """Phase 30: sequence parallelism.  The flash and FFN kernels at the
    ring's, Ulysses' and a sequence rank's shapes against their plain
    versions, timed there; then ranks started by distributed.spawn:
    BERT-base's sequence-parallel step over {dp: 1, sp: ranks} with ring
    attention and with Ulysses at full width (B=32, S=512, hidden
    dropout 0.1), its losses and master drift against the one-process
    step, and a planted fault that the drift must catch.
    Returns (rank 0's launches of both runs, the kernels' rows at the
    sequence-parallel shapes)."""
    import importlib

    import paddle_tpu_torch.distributed as dist_mod

    cards = torch.cuda.device_count()
    plan = _spmd_plan(cards)
    g = torch.Generator().manual_seed(30)
    sp_rows = {n: {} for n in TRAIN_KERNELS}
    _sp_flash(g, plan[0][1], sp_rows)
    torch.cuda.empty_cache()
    _sp_ffn(g, plan[0][1], sp_rows)
    torch.cuda.empty_cache()
    for name, modes in sp_rows.items():
        for mode, r in modes.items():
            lib = "none" if r["library_ms"] is None else \
                f"{r['library_ms']:.4f}"
            log(f"seq {name} {mode}: {r['ms']:.4f} ms (plain "
                f"{r['plain_ms']:.4f}, library {lib}, bound "
                f"{r['bound_ms']:.4f} {r['bound_by']}) at {r['shape']}")
    card = card_line()
    rank_fn = importlib.import_module("chip_smoke").seq_rank
    root = str(Path(__file__).resolve().parent)
    work = tempfile.mkdtemp(prefix="seq_")
    launches, results = None, {}
    try:
        for backend, n, gpus in plan:
            tag = f"{backend}{n}"
            env = {"PADDLE_DISTRI_BACKEND": backend,
                   "PYTHONPATH": os.pathsep.join(
                       [root] + [p for p in os.environ.get(
                           "PYTHONPATH", "").split(os.pathsep) if p])}
            t0 = time.perf_counter()
            dist_mod.spawn(rank_fn, args=(work, tag, SEQ_MODES), nprocs=n,
                           gpus=gpus, env=env)
            wall = time.perf_counter() - t0
            runs = [json.load(open(os.path.join(work, f"{tag}.{r}.json")))
                    for r in range(n)]
            results[tag] = runs
            log(f"seq {tag}: backend {backend}, world {n}, cards {gpus}; "
                f"spawn to exit {wall:.1f} s; ranks "
                f"{[round(r['rank_s'], 1) for r in runs]} s of work")
            launches = {k: sum(runs[0][m]["launches"][k] for m in SEQ_MODES)
                        for k in runs[0][SEQ_MODES[0]]["launches"]}
            for mode in SEQ_MODES:
                b = [r[mode] for r in runs]
                for r, x in enumerate(b):
                    log(f"seq {tag} rank {r}: BERT-base {mode} B={SEQ_BATCH}"
                        f" tokens {x['tokens']} of S={SEQ}: losses "
                        f"{x['losses']}; step ms (CUDA events) "
                        f"{[round(v, 3) for v in x['step_ms']]}; bytes a "
                        f"step {x['bytes_a_step']}; launches "
                        f"{x['launches']}")
                x = b[0]
                log(f"seq {tag}: BERT-base {mode} losses {x['losses']} "
                    f"against one process {x['one_process']}: rel err "
                    f"{x['sound']['loss_rel']:.3g} (rtol {SEQ_LOSS_RTOL}); "
                    f"master drift {x['sound']['drift']:.4g} at "
                    f"{x['sound']['drift_leaf']} (median "
                    f"{x['sound']['drift_median']:.4g}, limit "
                    f"{SEQ_DRIFT_LIMIT})")
                if "planted" in x:
                    c = x["planted"]
                    log(f"seq {tag}: control, {mode} with rank-local "
                        f"dropout masks: losses {c['losses']}, rel err "
                        f"{c['loss_rel']:.3g}; master drift "
                        f"{c['drift']:.4g} at {c['drift_leaf']} (median "
                        f"{c['drift_median']:.4g}): caught by the loss "
                        f"{c['loss_rel'] > SEQ_LOSS_RTOL}, by the drift "
                        f"{c['drift'] > SEQ_DRIFT_LIMIT}")
            for mode in SEQ_MODES:
                x = runs[0][mode]
                if x["sound"]["loss_rel"] > SEQ_LOSS_RTOL or \
                        x["sound"]["drift"] > SEQ_DRIFT_LIMIT:
                    raise AssertionError(f"{tag} {mode}: the sequence-"
                                         "parallel step parts from one "
                                         "process")
                c = x.get("planted")
                if c is not None and (c["loss_rel"] <= SEQ_LOSS_RTOL or
                                      c["drift"] <= SEQ_DRIFT_LIMIT):
                    raise AssertionError(f"{tag} {mode}: a check passes "
                                         "the planted fault")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("seq summary: " + json.dumps(dict(card=card, cards=cards,
                                          kernels=sp_rows, runs=results),
                                     default=str))
    return launches, sp_rows


def tensor_methods_ab(cycles=2):
    """The decode, seq2seq and srl phases `cycles` times in the turns on,
    off, off, on of the `matmul` / `unsqueeze` extensions (each phase
    logs its own step times); then each phase once more with the
    extensions counting their calls, and the host us of one call of
    each, extended and torch's own, on small CUDA tensors."""
    from paddle_tpu_torch.fluid.dygraph import math_op_patch as mp
    own = {"matmul": mp._TORCH_MATMUL, "unsqueeze": mp._TORCH_UNSQUEEZE}
    phases = {"decode": lambda: decode(None), "seq2seq": seq2seq,
              "srl": srl}

    def use(methods):
        for name, fn in methods.items():
            setattr(torch.Tensor, name, fn)

    for turn in ("on", "off", "off", "on") * cycles:
        use(mp.EXTENDED if turn == "on" else own)
        log(f"== extensions {turn}")
        for fn in phases.values():
            fn()
    calls = {}

    def counting(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    for phase_name, fn in phases.items():
        calls.update(matmul=0, unsqueeze=0)
        use({n: counting(n, f) for n, f in mp.EXTENDED.items()})
        t0 = time.perf_counter()
        fn()
        log(f"{phase_name}: extension calls {calls} in "
            f"{time.perf_counter() - t0:.1f} s of the phase")
    x, n = torch.ones(4, 4, device="cuda"), 100000
    for turn, methods in (("on", mp.EXTENDED), ("off", own)) * 2:
        use(methods)
        us = {}
        for name, call in (("matmul", lambda: x.matmul(x)),
                           ("unsqueeze", lambda: x.unsqueeze(0))):
            t0 = time.perf_counter()
            for _ in range(n):
                call()
            torch.cuda.synchronize()
            us[name] = (time.perf_counter() - t0) * 1e6 / n
        log(f"host us a call, extensions {turn}: {us}")
    use(mp.EXTENDED)


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the kernel arm of fused_ffn, opt-in as in paddle_tpu, for every
    # phase but ffn_arms (the default arm) and coverage (f32: neither
    # kernel family takes it)
    F.enable_fused_ffn()
    card()
    if FAILURES:
        sys.exit(1)
    if "--ssd" in sys.argv[1:]:
        ssd()
        sys.exit(1 if FAILURES else 0)
    if "--ctr" in sys.argv[1:]:
        ctr()
        sys.exit(1 if FAILURES else 0)
    if "--feed" in sys.argv[1:]:
        feed()
        sys.exit(1 if FAILURES else 0)
    build_kernels()
    if "--deploy" in sys.argv[1:]:
        deploy()
        sys.exit(1 if FAILURES else 0)
    if "--capi" in sys.argv[1:]:
        capi()
        sys.exit(1 if FAILURES else 0)
    if "--dist" in sys.argv[1:]:
        dist()
        sys.exit(1 if FAILURES else 0)
    if "--spmd" in sys.argv[1:]:
        spmd()
        sys.exit(1 if FAILURES else 0)
    if "--seq" in sys.argv[1:]:
        seq()
        sys.exit(1 if FAILURES else 0)
    if "--tensor-methods-ab" in sys.argv[1:]:
        tensor_methods_ab()
        sys.exit(1 if FAILURES else 0)
    rows = kernels()
    probed = probe()
    kernel_ms = {r["name"]: r["ms"] for r in rows or []}
    served = serve_slice(kernel_ms)
    decoded = decode({r["name"]: r for r in rows or []})
    trained = train(kernel_ms)
    if trained is not None:
        profile(trained[1])
    library = ffn_arms(trained[2] if trained else None)
    coverage()
    reference_check()
    resnet_path = resnet()
    fluid_path = fluid_resnet()
    wmt_paths = wmt()
    hapi_path = hapi()
    dygraph_path = dygraph_quickstart()
    s2s_paths = seq2seq()
    srl_paths = srl()
    mobile_paths = mobilenet()
    gan_path = cyclegan()
    static_paths = static_decode()
    amp_path = fluid_amp()
    ssd_path = ssd()
    ctr_path = ctr()
    deploy_path = deploy()
    capi_path = capi()
    feed_path = feed()
    dist_path = dist()
    spmd_out = spmd()
    seq_out = seq()
    if FAILURES or None in (rows, probed, served, decoded, trained, library,
                            resnet_path, fluid_path, wmt_paths, hapi_path,
                            dygraph_path, s2s_paths, srl_paths,
                            mobile_paths, gan_path, static_paths, amp_path,
                            ssd_path, ctr_path, deploy_path, capi_path,
                            feed_path, dist_path, spmd_out, seq_out):
        log(f"FAILED phases: {FAILURES}")
        print(f"FAILED phases: {FAILURES}", file=sys.stderr, flush=True)
        sys.exit(1)
    rows += probed[0]
    paths = {"serving": served, "decode": decoded, "train": trained[0],
             "probe": probed[1], "library_train": library,
             "resnet": resnet_path, "fluid": fluid_path, **wmt_paths,
             "hapi": hapi_path, "dygraph": dygraph_path, **s2s_paths,
             **srl_paths, **mobile_paths, "cyclegan": gan_path,
             **static_paths, "fluid_amp": amp_path, "ssd": ssd_path,
             "ctr": ctr_path, "deploy": deploy_path, "capi": capi_path,
             "feed": feed_path, "dist": dist_path, "spmd": spmd_out[0],
             "seq": seq_out[0]}
    for r in rows:
        # `launches` is the count on the path where the kernel runs: the
        # probe for its three kernels, the decode path for ragged_paged,
        # the default-arm train step for the FFN's element pass, the
        # kernel-arm train step for the others; the other paths' counts
        # stand beside it
        name = r["name"]
        path = "probe" if name in PROBE_KERNELS else \
            "library_train" if name in ACT_KERNELS else \
            "train" if name in TRAIN_KERNELS else "decode"
        r["launches"] = paths[path][name]
        r["launches_by_path"] = {p: n[name] for p, n in paths.items()}
        if name in spmd_out[1]:
            # its time, bound and library call at a tensor-parallel
            # rank's shape and offsets (the spmd phase)
            r["tensor_parallel"] = spmd_out[1][name]
        if name in seq_out[1]:
            # the same at the ring's, Ulysses' and a sequence rank's
            # shapes (the seq phase)
            r["sequence_parallel"] = seq_out[1][name]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
