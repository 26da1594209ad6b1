#!/usr/bin/env python3
"""Smoke run of the PyTorch port (spiking_fullsubnet_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and the exit code
is non-zero:

1. card     the GPU's name and power limit (nvidia-smi), torch and CUDA;
2. build    nvcc builds the kernels from csrc/ for sm_90a, one process per
            library, all at once (ptxas summary);
3. kernels  each kernel against its plain PyTorch version on the inputs the
            main path gives it (captured from a forward), in f32 and bf16:
            A (fullband stack) and B (merged sub-band sections with the deep
            filter) on zoo M's offline path, C (the whole-model monolith) on
            flagship M (random weights from seed 0), F (a GSU stack from the
            raw features) at each of the four stacks of zoo M's layered
            forward (separator_config's default scan_mode) and at
            cIRM-GSN's one stack:
            - the quality forward's inputs (1 x 2 s), whole sequence:
              A and F spike mismatch < 1e-3; B enhanced-spectrum and C
              enhanced-chunk relative L2 error < 0.05 (the spike-flip bound
              of tests/test_tpu_kernels.py:242);
            - the bench batch (256 x 30 s), first 16 frames (steps): the same
              bounds, and A's 4-D units form and collect_all equal its 3-D
              form exactly;
            - the whole bench sequence: rounding in another summation order
              flips near-threshold spikes and each flip cascades along its
              row, so the kernel and the plain version drift apart with
              length. Both are held against a float64 run of the plain
              version on the same inputs: the kernel must stay within 3x
              (+1e-3) of the float32 plain version's own drift (F on the
              first 256 rows of each stack: rows are independent in eval;
              cIRM-GSN has 256 rows in all);
4. quality  the main paths, each counted (counts set to 0 just before the
            forward, read just after), bf16 serving policy, through
            SpikingFullSubNet on the speech-like fixture (1 x 2 s):
            - zoo M (model_zoo/.../baseline_m.npz) with the offline norm:
              SI-SDR gain > 8 dB, one launch each of A and B, none of C;
            - zoo M with the cumulative laplace norm (monolith): gain > 8 dB,
              one launch of C, none of A or B;
            - flagship M (pre-LN, random weights): finite audio of the input's
              shape, one launch of C;
            - zoo M layered (scan_mode="layered", every layer's spikes
              collected): gain > 8 dB, four launches of F, none of A, B or C;
            - cIRM-GSN (recipes/intel_ndns/cirm_gsn/default.toml widths,
              random weights from seed 0): finite audio, one launch of F;
5. timing   one forward each of zoo M (serving and layered), flagship M
            (bench.py's headline configuration) and cIRM-GSN at batch
            256 x 30 s bf16, with peak memory, and each kernel alone,
            with CUDA events; the kernels' times, plain versions' times and
            bounds as one JSON line. A bound is the larger of the bytes
            (each input read once, each output written once, over
            3.35 TB/s) and the operations this run's data needs: spike
            products count only the spikes that fired (counted by the plain
            versions), layer-0 products of the units only the lanes each
            unit's unfold reads, F's layer-0 product and the DFT products
            dense, over 989 TFLOP/s (bf16)
            or 67 TFLOP/s (f32), and the f32 cell, statistics and deep-filter
            arithmetic over 67 TFLOP/s. Kernel C besides: its plan (rows a
            tile, blocks a cluster, clusters in flight against the card's
            cudaOccupancyMaxActiveClusters, waves; one wave required), its
            time at half the batch, two launches on the bench's inputs
            bitwise equal, one profiled launch's SM cycles a step in each
            stage (io, fullband and unit blocks), and the time of packing
            its weights (monolith_pack, done once a spec, outside its time).
            Kernels A (zoo M's served fullband), B (zoo M's sections) and F
            (each of its five launches) besides: their plans (sections_plan:
            rows a tile, unit groups, blocks; stack_x_plan: columns a block,
            blocks a cluster, for A over its (unit, row) columns), one
            profiled launch's SM cycles a step in each phase (products,
            cell, exchange and barrier, the step's outputs), the time of
            packing their weights (stack_pack, sections_pack, stack_x_pack:
            done at every launch, inside its time), and two launches on the
            bench's inputs bitwise equal.
6. training the layered training step (recipes/denoise.train_step: the
            denoise loss, backward, clipping by global norm 10, AdamW) of
            zoo M (separator_config's default, from baseline_m.npz) and of
            cIRM-GSN (random weights from seed 0), every GSU layer on
            kernels D (forward) and E (backward, its dW kernel beside it):
            - D and E against their plain versions on the arguments
              recorded at the wrappers during one f32 forward and backward
              of each configuration (10 layers: zoo M's 4 stacks x 2, cIRM-
              GSN's 2), on the fixture batch (below) and on the training
              batch (64 x 6 s, T = 751). The batch statistics couple the
              rows, so one rounding flip (every few dozen steps at these
              sizes) moves a whole layer onto another trajectory. So every
              step of every layer is recomputed in float64 from the layer's
              own previous membranes: D's membranes and statistics must
              match it within 3x (+1e-4) of the plain f32 version's error
              on its own trajectory, and a spike of the other sign must
              have |membrane| < 1e-3 there (a flip at the threshold, not a
              fault); against a float64 run of D's plain version (W_hh
              rounded to the stream type), each layer's membranes, up to
              and with the step where its spikes part from that run's
              (which bounds the flipped spikes' distance from the
              threshold), within 3x (+1e-4) of the plain f32 version's up
              to its own parting; the spike drift after that step is
              logged, not held (a layer's drift is one chaotic draw for
              the kernel and the plain version alike, unlike F's
              independent rows); E on identical inputs, relative L2 < 1e-3 (the
              fixture's whole sequence, the training batch's first 16
              frames); the dW kernel on identical inputs (float32 streams),
              relative L2 < 1e-5 (DW_F32_REL), and its two launches on the
              same inputs bitwise equal; D's and E's two launches on the
              same inputs bitwise equal;
            - five train_steps on one fixed batch of the speech fixture
              (eight copies shifted in time, each with its own noise, 8 x 2 s;
              see FIXTURE_COPIES): every loss and gradient finite, the BN
              running statistics moved,
              cIRM-GSN's last loss below its first; each step counted: D
              and E 8 launches (zoo M) or 2 (cIRM-GSN), A, B, C, F none;
            - one step's gradients through the kernels against the same step
              with E swapped for its plain version (D's forward is the same
              in both): every gradient leaf's relative L2 < 1e-2;
            - the train step at 64 x 6 s bf16: one warm-up step counted
              as in the quality phase (D and E as above, A, B, C, F none;
              the kernels line's launches), then forward, backward, clip
              and AdamW timed with CUDA events over two more consecutive
              steps, audio-s/s, its own peak memory, every step's loss and
              gradient norm; D, E and E's dW kernel alone at each of the ten
              layers, their plain versions, bounds (D: xg read, spikes, y and
              statistics written; operations the fired spikes' products and
              the cell and BN arithmetic; E: xg, y and gout read, dxg
              written; the recompute, the dense dh = drg W^T and the
              spike-sparse dW) and torch.matmul on dW's product as the
              library yardstick; D's and E's plans (ops/gsu_kernels.
              train_plan: blocks, units a block, what lies in shared memory)
              and one profiled launch each (train_profile: SM cycles a step
              in each phase of the kernel).
7. stream   training on the stream path (scan_mode="auto" on the card),
            the bf16 policy, every GSU layer on kernels D and E with bf16
            streams (membranes float32), batch 64 x 6 s:
            - D, E and the dW kernel with bf16 streams against their plain
              versions on the arguments recorded at the wrappers during one
              forward and backward of flagship M (bench.py:56-69's training
              configuration, random weights from seed 0; 8 layers): D held
              at every step as in phase 6; E over whole sequences, the
              kernel and its plain version each against a float64 run of
              the plain version (which does not round drg to bf16), the
              kernel within 3x (+1e-5) of the plain version's error (a drg
              at a bf16 midpoint rounds either way); dW on identical inputs,
              relative L2 < 1e-3, two launches bitwise equal (D's and E's
              too);
            - the same at baseline L's section stacks of 1024 and 1536 rows
              x 256 units (recipes/intel_ndns/spiking_fullsubnet_freeze_phase/
              baseline_l.toml [model.args], random weights from seed 0):
              beyond kernel D's former row cap;
            - one step's gradients through the kernels against E's plain
              version on the same forward, flagship M, zoo M and baseline L
              on the fixture batch with f32 streams (relative L2 < 1e-2 per leaf,
              as phase 6); flagship M with bf16 streams: the kernels' and
              the plain version's gradients each against the same step with
              E in float64, the kernel's largest leaf error within 3x
              (+1e-5) of the plain version's;
            - train steps timed as in phase 6 (one counted warm-up step,
              then forward, backward and clip-and-AdamW): flagship M and
              zoo M (D, E and dW 8 launches each, A, B, C and F none) and
              baseline L (10 each, one timed step); D, E and dW alone at
              flagship M's eight layers and at baseline L's four section
              layers of 1024 and 1536 rows, their plain versions, bounds and
              torch.matmul on dW's product in bf16; dW's split-K plan (splits
              and rows a split) at each launch; D's and E's plans and phase
              profiles as in phase 6.
8. modes    serving in every mode of kernel B and on the collect path,
            each on a configuration whose forward takes it (each misses the
            monolith's gate): "ln" flagship M with a fullband tanh (its
            weights), "cum" zoo M with the cumulative norm at fdrc 0.4
            (baseline_m.npz), "raw" flagship widths without norm or pre-LN
            with a fullband tanh (random weights from seed 0):
            - B against its plain version on the inputs each path gives it,
              f32 and bf16: 1 x 2 s whole and the bench's first 16 frames,
              enhanced-spectrum relative L2 < 0.05; "ln" over the whole
              bench against a float64 run of the plain version, within 3x
              (+1e-3) of the f32 plain version's drift; the projection mode
              (no deep filter; no caller reaches it) at 16 frames: on "ln"'s
              inputs against its plain version, relative L2 < 1e-3, and on
              every mode's, deep-filtered here, against the kernel's own
              deep-filter mode on the same inputs (the same spikes): < 1e-4
              in f32, < 1e-2 in bf16 (projections rounded to bf16 first);
            - B against C on one model: the two-launch path
              (stream_forward._serve_two_launch) and the monolith on
              flagship M and on zoo M with the cumulative norm, f32,
              1 x 12345 samples, enhanced audio SNR > 60 dB (the JAX
              package's bound for two formulations of one forward,
              tests/test_stream_forward.py:65-90); zoo M's cumulative norm
              through B gains > 8 dB on the fixture, A and B one launch;
            - each mode's path counted (A and B one launch, C and F none);
              the collect path on zoo M (collect_layer_outputs=True, the
              config's default): gain > 8 dB, A four launches (fullband and
              three sections in the units form), B, C and F none, the
              synops lists shaped as the layered forward's, their spikes
              within a mismatch of 1e-3 of the same forward on the plain
              versions;
            - at 256 x 30 s bf16: the forwards of flagship M with collect
              (the preset's default) and of the three mode configurations,
              each counted in a warm-up that also records the kernels'
              inputs, with own peak memory; A alone at the collect path's
              four launches (each with A's plan, phase profile, packing
              time and two launches bitwise equal, as in phase 5) and B
              alone in each mode (and the projection mode on "ln"'s
              inputs), their plain versions and bounds.
9. trainer  the recipe trainer through its CLI (runtime.cli.main on the
            card): recipes/intel_ndns/spiking_fullsubnet_freeze_phase/
            baseline_m.toml read with the port's toml_load ([meta],
            [trainer.args] with max_epochs = 2, [optimizer], [acoustics],
            [model]: build_separator at zoo M width, layered, f32, random
            weights from the recipe's seed) on SyntheticNoisyDataset
            (DNS data is not in the repository): train 128 x 6 s at batch 64
            (two updates an epoch), validate 16 x 6 s at batch 16, test
            2 x 6 s at batch 1. It runs train, then train -R with
            max_epochs = 3, then test and validate on --ckpt_path best, the
            counts set to 0 before the first and read after the last, and
            checks: every loss and gradient norm finite; each update
            launching D, E and dW 8 times and nothing else, each validation
            or test batch F 4 times and nothing else; epoch_0001,
            epoch_0002 and best written, the epoch directories rotated at
            max_num_checkpoints; the resume running epoch 3 alone to
            epochs_trained 3; the re-validation of best equal to its
            recorded score bit for bit; the test metrics CSV with si_sdr,
            synops and neuron_ops. It prints the ms per update inside the
            trainer (CUDA events from the end of one update to the end of
            the next within an epoch), the same step bare (train_step on the
            first training batch, timed as phase 6), the ms per validation
            batch and the trainer's own peak memory.
10. flagship the paper's recipes (recipes/intel_ndns/spiking_fullsubnet):
            (a) the fused forward (scan_mode="fused") at baseline_m.toml's
            [model.args] (flagship widths, pre-LN, f32, random weights from
            its seed): on the speech fixture (1 x 2 s) the kernel route (the
            layered formulation: F in eval, D, E and dW in training)
            against the fused plain version run on the card (spike mismatch
            per layer < 1e-3, audio relative L2 < 0.05) and against
            scan_mode="layered" bit for bit, F 4 launches and nothing else;
            one eval forward at 16 x 6 s and one train step at 64 x 6 s
            timed, D, E and dW 8 launches a step and nothing else;
            (b) baseline_m_GAN.toml through runtime.cli.main on
            SyntheticNoisyDataset (train 128 x 6 s at batch 64, validate
            16 x 6 s at 16, test 2 x 6 s at 1): train with max_epochs = 1,
            train -R with 2, test on --ckpt_path best; every loss and
            gradient norm finite, each update D, E and dW 8 launches and
            nothing else, each validation or test batch F 4, the
            discriminator's weights, u and v moved by its step, epoch 1's
            checkpoint holding the discriminator and its optimizer state
            (step 2), the resume running epoch 2 alone; it prints the ms per
            GAN update inside the trainer split into the generator step
            (CUDA events), the host targets (host clock) and the
            discriminator step (CUDA events), the generator step bare, and
            the phase's own peak memory;
            (c) the freeze phase's baseline_m_dualGAN.toml (zoo M width,
            offline norm, two discriminators with ExponentialLR): one epoch
            of two updates; both discriminators move, each one's rate and
            the generator's equal to their schedules;
11. serving the hop-synchronous stream, the serving export and the
            reference-checkpoint import: (a) flagship M (random weights from
            seed 0, f32) streamed at batch 1, one hop a step, over 10 s of
            Gaussian audio (0.1 rms, seed 0), primed: the interior against
            the offline forward (kernel C) within 2e-4 (the bound of
            tests/test_streaming.py for the same two formulations) while
            every spike equals the layered forward's, else, where spikes
            flip (printed per layer), within a relative L2 of 0.05 (the JAX
            tests' allowance for sparse flips, tests/test_tpu_kernels.py:
            240-242); no kernel launched; the CUDA graph's output and final state
            equal the eager step's bit for bit over the whole stream; ms per
            hop (CUDA events, the mean of 512 hops after a warm-up) of the
            graph and the eager step at chunk_frames 1 and 4 beside the 8 ms
            budget; (b) zoo M with the cumulative norm streamed over the
            speech fixture: SI-SDR gain > 8 dB, the interior against the
            served forward as in (a); (c) flagship M exported
            (tools/export_serving) offline at 1 x 30 s on scan_mode "auto"
            (kernel C) and "fused" (kernel F) and as the streaming step
            (batch 1, one hop), each saved, loaded and run equal to the live
            graph at atol 0, the loaded offline programs launching C once and
            F four times, the streaming one nothing; torch.library.opcheck on
            the operators of A, B, C and F at narrow models' shapes; (d) zoo
            M's weights saved as a frozen-generation reference checkpoint
            (the reference's key names, DDP's "module." prefix), then
            runtime.cli -M test --torch_ckpt on freeze_phase/baseline_m.toml
            with phase 9's synthetic test set: the trainer's weights equal
            SpikingFullSubNet.from_npz's bit for bit, F four launches a
            test batch;
12. separation and dereverberation: the recipes of recipes/wsj0-mix and
            recipes/reverb through runtime.cli at their default.toml
            widths (random weights from each recipe's seed), each with
            validation and a checkpoint every epoch:
            (a) wsj0-mix/spiking_fullsubnet (two speakers, 8 kHz, n_fft 256,
            fb 320, sb 224, f32): its eval route (the layered forward) on a
            1 x 4 s SyntheticMixDataset mixture against the fused plain
            version run on the card (spike mismatch per layer < 1e-3, audio
            relative L2 < 0.05, F 4 launches and nothing else); then on
            SyntheticMixDataset (wsj0-mix is not in the repository) train
            64 x 4 s at batch 32, validate 8 x 4 s and test 2 x 4 s at batch
            1: train with max_epochs = 1, train -R with 2, test on
            --ckpt_path best; every loss and gradient norm finite, each
            update D, E and dW 8 launches and nothing else, each eval batch
            F 4, the resume running epoch 2 alone, the test CSV with si_sdr;
            it prints the ms per update inside the trainer, the same PIT
            step bare (timed as phase 6), the ms per validation batch and the
            phase's own peak memory; then D, E and dW against their plain
            versions on the arguments of one PIT training step of the
            trained weights on a training batch, at phase 6's limits (D
            whole sequences by check_d, E within relative L2 1e-3 on its
            first 16 frames and on whole sequences, dW within 1e-5);
            (b) wsj0-mix/conv_tasnet (base = true) and wsj0-mix/cirm_lstm:
            one epoch of two updates at the recipe's batch (16 and 32) x
            4 s, then test; finite losses, no launch of A-F or dW (the JAX
            package has no Pallas kernel on these models), the ms per update
            and the peak memory;
            (c) reverb/spiking_fullsubnet (zoo M widths, pre-LN, 16 kHz) on
            scp data the phase writes (64 + 6 Gaussian utterances of 4.5 s,
            each with a decaying echo tail), its config written by
            toml_dump (its two [[test_dataset]] load back) through
            runtime.cli.main: train two updates of 32 x 4 s, then predict on
            the best checkpoint over the simulated and real evaluation
            lists; D, E and dW 8 launches an update, F 4 an eval or predict
            batch, the predicted wavs mirroring the far_test tree under each
            dataloader's directory; then D, E and dW against their plain
            versions at (a)'s limits on one step of a REVERB training batch.
13. remaining models: f32, TF32 off, random weights from seed 0:
            (a) the shared sub-band ablation at zoo M layered's widths
            (separator_config with the offline norm, shared weights, BN, fb
            320, sb 224, cutoffs 0/32/128/256, centres 4/32/64, neighbours
            15) with sb_shared_bottleneck = 224, on phase 6's training
            batch (64 x 6 s): the eval forward counted (F 2 launches, the
            fullband and the one shared stack of 13 x 64 rows, nothing
            else), each F launch against its plain version (the first
            WINDOW frames spike mismatch < 1e-3; the first ROWS_F64 rows of
            the whole sequence against float64 within 3x (+1e-3) of the
            plain version's drift, as phase 3); one train step counted and
            timed as phase 6 (D, E and dW 4 launches each) and D, E and dW
            against their plain versions at its four layers at phase 12's
            limits; the forward's, the step's and each launch's ms;
            (b) recipes/intel_ndns/sdnn_delays/baseline.toml (257 -> 512 ->
            512 -> 257, max_delay 64, threshold 0.1) through
            runtime.cli.main on SyntheticNoisyDataset: train two updates of
            32 x 4 s, validate 16 x 4 s at 16, train -R to epoch 2, test
            and predict 2 x 4 s on best; finite losses, no kernel launched,
            the ms per update and per validation batch;
            (c) ALIF (sequence_model="ALIF") at zoo M widths, 8 x 4 s: the
            eval forward and one training forward and backward of the
            denoise loss, each against a float64 run of the same code on
            the card: spike mismatch <= 0.05 a layer (the JAX tests'
            allowance, tests/test_tpu_kernels.py:240-242), audio relative
            L2 < 1e-2, the loss and gradient norm finite;
            (d) FullSubNet at its published widths (DNS-Interspeech-2020's
            train.toml: 257 bins, look-ahead 2, LSTM, fb 512 with ReLU, sb
            384 with 15 neighbours, offline laplace norm, drop-band in 2
            groups; n_fft 512, hop 256) at 8 x 4 s: the eval forward's cIRM
            and the gradient of an MSE against the drop-banded cIRM target
            of one training forward, each against a float64 run on the
            card: relative L2 < 1e-4 (every gradient leaf's).
14. distributed  data-parallel training (parallel/) on the flagship recipe's
            baseline_m.toml (M widths, pre-LN, scan_mode "fused": the layered
            formulation on D, E and dW in training, F in eval) on phase 9's
            SyntheticNoisyDataset of 6 s items, each run in its own process
            started together, stopped when one fails or after 300 s:
            (a) python -m spiking_fullsubnet_torch.runtime.cli -M train
            under torchrun's variables at world size 1 on NCCL, three
            updates of 64 x 6 s and a validation of 16 x 6 s, and the same
            command without them: the epoch checkpoint's weights, model
            state and optimizer state and the best checkpoint's trainer
            state bitwise equal;
            (b) two ranks over gloo sharing cuda:0 (python3 chip_smoke.py
            --dist-rank <dir> gloo cuda:0, one process a rank; what
            tools/data_parallel_check.py runs on several cards over NCCL),
            each with 8 x 6 s rows
            of one update and 8 x 6 s of validation, runtime.cli.main
            counted in each rank (counts set to 0 just before, read just
            after): D, E and dW 8 launches in the update and F 4 in the
            validation batch on each rank; both ranks' weights and model
            state bitwise equal; then this process runs the same model on
            each rank's rows through the same kernels: the ranks' averaged
            gradients within relative L2 1e-6 of its average of the two,
            and the clip and AdamW's step from the ranks' average at the
            rate of two ranks give the ranks' update and rank 0's model
            state within relative L2 1e-6; the gradient norm within 1e-5
            and the rate equal; the ms of each rank's gradient average.
15. surface  the rest of the JAX package's surface, at zoo M layered
            (separator_config as it comes, f32, baseline_m.npz) on 16 x 6 s
            of phase 6's training batch:
            (a) the activation tracer (nn/module_tracer.py) in eval, counted:
            F 4 launches traced as untraced (its traced instance), the
            frame names equal the CPU route's (1 x 0.25 s); at F's
            captured arguments the traced instance against F's plain
            version over the first 16 frames (max |c| within 1e-2
            relative, min |c| within 1e-3; over the whole sequence a flip
            cascades, 1.5 % of the spikes at 751 frames), and each
            membrane frame equal to its launch's trace and held over the
            whole sequence against the plain cell given the kernel's own
            spikes (max |c| within 1e-3, min |c| within 1e-4, spikes not
            reproduced < 1e-4), finite flags equal; the output with the
            tracer closed bit for bit the one before and the one under it;
            the forward's and F's ms traced and not;
            (b) +inf in fullband layer 1's weight_hh[0, 0]: the traced
            forward raises FloatingPointAbort whose first line names
            fb/gsu_layer1/membrane, with the module trail, F launched;
            (c) one layered train step (denoise loss, backward) traced and
            not: D, E and dW 8 launches each way, the loss and every
            gradient bitwise equal, the 8 membrane frames equal to the
            extremes of kernel D's y at the step's captured arguments;
            (d) every models/modules.py function in CUDA float32 (TF32 off)
            against its CPU float64 result, relative L2 < 1e-4: the TCN at
            Conv-TasNet's widths (N 512, B 128, H 512, P 3, X 8, R 3), TAC
            and the recurrences at 128-256 units (64 steps: the random
            LayerNormLSTM is chaotic), the conformer convolution at 256
            channels, MVDR over 6 channels x 257 bins;
            (e) the native reader (native/wavio.py, built with g++): 64
            int16 WAVs of 30 s (61 MB) in a temporary directory, read_batch
            of 64 x 6 s crops bit for bit scipy's read and crop, the DNS
            dataset (data/dns_audio.py) on its native path equal to its
            scipy path; the ms of each.
16. band   band-parallel sub-bands (parallel/mesh.py, the fused forward's
            band axis, kernels D and E in band mode), flagship M at full
            width (models/presets.flagship_m, scan_mode "fused", random
            weights from seed 0), 8 x 2 s of harmonic tones in noise from
            seed 16, the step of __graft_entry__.dryrun_multichip (value and
            gradient of the denoise loss, clip 10, AdamW 1e-3):
            (a) NCCL at world size 1 in this process, a (1, 1) mesh: the
            eval forward and the step with band_axis set under the mesh bit
            for bit those without a mesh;
            (b) two gloo ranks sharing cuda:0 (python3 chip_smoke.py
            --band-rank <dir> gloo cuda:0 1 2, one process a rank; what
            tools/band_parallel_check.py runs on several cards over NCCL)
            on a (1, 2) mesh, each counted (counts set to 0 just before,
            read just after): an eval forward (F 4 launches a rank) and the
            step (D and E in band mode 6 launches each, D and E 2 for the
            fullband, dW 8), its collectives counted; the two ranks' output
            and BN state bit for bit equal, their updated weights too; the
            reduced gradients equal to the ranks' own summed over the band
            group and averaged over the data group (1e-6); each held
            against this process's unsharded run on the same rows: every
            layer's spikes < 1e-3 apart and the audio within relative L2
            0.05 (phase 10's bounds of the fused route); where the training
            spikes equal the unsharded run's, the loss within 1e-5
            relative, the BN state 1e-5 and the gradients 1e-4 relative L2,
            and after a flip (the BN sums in another order can flip a
            threshold membrane, and batch statistics spread it over its
            layer) the loss within 1e-2 and the spikes 25 % apart, logged;
            the update within 1e-5 of this process's clip and AdamW on the
            ranks' own reduced gradients (AdamW's first step is +-lr
            wherever a gradient's sign flips); D band against its plain
            band version at each of the step's six launches on its first 96
            frames: over the first 16 (spike mismatch < 1e-3) and step by
            step from its own membranes (the group's sums over the rank's
            collective, to 3x the plain version's rounding), E band with dW
            within relative L2 1e-3 of its plain version; each launch timed
            beside its plain version and its bound; the ms of each rank's
            eval forward and step beside the unsharded ones; both ranks on
            the staged route (two processes on one card: parallel/mesh.
            band_route), logged with each band launch's ms in the step;
            (c) the group route on this card: kernels D and E in band mode
            as redesigned (their band instances, BN's sums swapped between
            the ranks' clusters inside one launch a layer), G = 2 and 4
            ranks' rows as the band split lays them (the units of each
            section padded to a multiple of G, a rank's units as rows;
            with G = 4 section 1's last rank holds only pad rows), at
            flagship M's six section layers as one unsharded step gives
            them to D and E (their first 96 frames, f32 streams) and
            section 1's two layers again in bf16: against the plain band
            versions run for every rank in lockstep (threads summing in
            rank order), D's spikes over the first 16 frames < 1e-3 apart
            and every step from its own membranes within 3x the plain
            version's rounding + 1e-4 (flips within 1e-3 of the
            threshold), every rank's stats bit for bit equal, E with dW on
            D's outputs within relative L2 1e-3 (1e-2 in bf16: drg rounds
            to bf16, a tie either way); counted (set to 0 just before,
            read just after): one D band and one E band launch a layer and
            no collective; each launch timed beside its plain version and
            its bound (the G ranks' work); then a launch whose peer never
            writes raises within the hang guard's limit (0.5 s) instead of
            hanging.
17. tools  the bench support (runtime/{timing,roofline}) and the port's
            tools (spiking_fullsubnet_torch/tools/), each through its main:
            (a) time_fn_per_iter on a bf16 8192^3 torch.matmul: its rate in
            (100, 989] TFLOP/s (above the peak means nothing ran);
            (b) the same timer on flagship M's bf16 forward at 4 x 30 s
            (kernel C), and roofline_report at that throughput: mfu and
            fraction_of_roofline in (0, 1];
            (c) bench_gsu_kernel --train at its defaults (64 x 512 frames,
            320 x 320, shared, f32): kernel D against its plain version on
            identical inputs, spike mismatch < 1e-3 over the first 16
            frames; E (relative L2 < 1e-3 there) and dW (< 1e-5), on
            identical inputs; each wrapper's launches equal to the tool's
            calls;
            (d) profile_trace --serving --batch 8 --seconds 2: both Chrome
            traces parse as JSON; the forward's summary rows name kernel C
            and the train step's D and E; the profile's rows of C, D, E and
            dW have as many calls as each wrapper counted in the profiled
            run;
            (e) reproduce_board on five synthesized DNS utterances of 30 s
            (the set's length: its dataset pads shorter items with zeros),
            baseline_m.toml's widths with zoo M's shipped config (offline
            norm, no pre-LN, the Separator's fullband input, the layered
            forward: separator_config's) and zoo M's weights as a reference checkpoint
            (--torch_ckpt), counted: F 4 launches a test batch; the row's
            SI-SNR finite and above 8 dB, its params 953,704,
            latency_total_ms 8.036; then the recipe CLI's
            predict on the same TOML and calculate_metrics over its WAVs
            (the card's machine has no pandas), its SI-SDR within 0.1 dB
            of the row's;
            (f) build_model_zoo --sizes m --utts 8 on a reference-layout
            tree written from baseline_m.npz, counted (F 4 launches an
            utterance): params 953,704, SI-SNR within 0.25 dB of
            model_zoo/entries_framework.json's 14.88.

About 12 to 15 minutes on one H100, the build included.

The last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the rest of the repository beside it, it prints no result and
exits non-zero.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ZOO_M = ROOT / "model_zoo" / "intel_ndns" / "spike_fsb" / "baseline_m.npz"
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# f32 operations per hidden unit, layer and row-step: sigmoid, gate mix, BN, threshold
CELL_OPS = 13
BENCH_B, BENCH_SECONDS, SR = 256, 30.0, 16000
WINDOW = 16  # leading bench frames held tightly
# dW on float32 streams against its plain version: the three-way bf16 split
# keeps float32's products (TF32 would give about 3e-4 at these shapes, the
# hi term alone about 1e-3); bf16 streams are held at 1e-3
DW_F32_REL = 1e-5
# recipes/intel_ndns/cirm_gsn/default.toml [model.args]
CIRM_GSN = dict(n_fft=512, hop_length=128, win_length=512, fdrc=0.5, input_size=257,
                hidden_size=256, num_layers=2, proj_size=257, output_activate_function=False,
                df_order=3, use_pre_layer_norm_fb=True, bn=True, shared_weights=True,
                sequence_model="GSN", num_spks=1)


T0 = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def stamp(phase):
    log(f"[time] {phase} starts at {time.perf_counter() - T0:.1f} s")


def require(ok, what):
    """A failed check raises (unlike assert, also under python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def speech_fixture():
    """tests/test_spiking_fullsubnet.py:212-234: AM harmonic stack + noise."""
    rng = np.random.default_rng(5)
    t = np.arange(32000) / 16000.0
    f0 = 120 + 20 * np.sin(2 * np.pi * 2.3 * t)
    phase = 2 * np.pi * np.cumsum(f0) / 16000
    sig = sum(np.sin(k * phase) / k for k in range(1, 9))
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.1 * t - 1.2)) * np.exp(
        -0.5 * ((t % 1.0) - 0.5) ** 2 / 0.09)
    clean = (0.2 * env * sig).astype(np.float32)
    return clean, clean + 0.05 * rng.standard_normal(len(t)).astype(np.float32)


def card_name():
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


def training_batches(dev):
    """(noisy, clean) of the fixture batch (FIXTURE_COPIES shifted copies of
    the speech fixture, each with its own noise) and of the training batch
    (TRAIN_B x TRAIN_SECONDS of Gaussian noise as clean, more as noise),
    from one generator seeded 1."""
    clean, _ = speech_fixture()
    trng = np.random.default_rng(1)
    fix_clean = np.stack([np.roll(clean, k * clean.size // FIXTURE_COPIES)
                          for k in range(FIXTURE_COPIES)])
    fix_noisy = torch.from_numpy(fix_clean + (0.05 * trng.standard_normal(
        fix_clean.shape)).astype(np.float32)).to(dev)
    tb_shape = (TRAIN_B, int(TRAIN_SECONDS * SR))
    tb_clean = (trng.standard_normal(tb_shape) * 0.1).astype(np.float32)
    tb_noisy = torch.from_numpy(tb_clean + (0.05 * trng.standard_normal(tb_shape)).astype(
        np.float32)).to(dev)
    return (fix_noisy, torch.from_numpy(fix_clean).to(dev), tb_noisy,
            torch.from_numpy(tb_clean).to(dev))


def si_sdr(est, ref):
    a = np.dot(est, ref) / np.dot(ref, ref)
    return 10 * np.log10(np.sum((a * ref) ** 2) / np.sum((a * ref - est) ** 2))


def si_sdr_gain(y, clean, noisy):
    """SI-SDR gain in dB of the enhanced fixture ``y [1, T]`` over the noisy
    one; the audio must be finite and of the fixture's shape."""
    enh = y[0].float().cpu().numpy()
    require(enh.shape == clean.shape and np.isfinite(enh).all(), "enhanced audio shape/finite")
    return float(si_sdr(enh, clean) - si_sdr(noisy, clean))


def cuda_ms(fn, iters=1, warmup=1):
    """Mean milliseconds of fn() over iters runs, CUDA events, after warmup."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def plain_run(plain, args, **kw):
    """One run of a plain version: (its ms by CUDA events, the per-layer
    spike counts it took, its output)."""
    counts, box = [], []
    ms = cuda_ms(lambda: box.append(plain(*args, spike_counts=counts, **kw)), warmup=0)
    return ms, counts, box[0]


WRAPPERS = {"A": "gsu_stack_eval", "B": "gsu_sections_eval", "C": "sfsb_monolith_serve"}
COUNTERS = dict(WRAPPERS, F="gsu_stack_eval_x")
TRAIN_WRAPPERS = {"D": "gsu_layer_train_fwd", "E": "gsu_layer_train_bwd", "dW": "gsu_train_dw"}
TRAIN_B, TRAIN_SECONDS = 64, 6.0  # bench.py:254's training shape (T = 751 frames)
# copies of the speech fixture in the training checks' batch, each shifted in
# time and with its own noise: batch statistics over one row make BN's
# gradient exactly zero, over two or four rows of one utterance they let the
# first fullband layer's gradient grow without bound (the JAX package's too:
# 1e70 in float64 at two rows), and over identical rows c' - mean is a
# cancellation whose sign rounding decides
FIXTURE_COPIES = 8

ROWS_F64 = 256  # rows of each F stack held against float64 over the whole bench
BASELINE_L_TOML = (ROOT / "recipes" / "intel_ndns" / "spiking_fullsubnet_freeze_phase"
                   / "baseline_l.toml")
# kernel D's and E's launches of the stream-train steps checked in phase 7
LAYERS_FLAGSHIP = tuple(f"flagship M {stack} layer {k}"
                        for stack in ("fullband", "section 0", "section 1", "section 2")
                        for k in (0, 1))
# kernel F's launches checked: zoo M layered's four stacks, then cIRM-GSN's one
STACKS_F = ("zoo M fullband", "zoo M section 0", "zoo M section 1", "zoo M section 2",
            "cIRM-GSN")
# kernel D's and E's launches, in D's order: zoo M's four stacks, then cIRM-GSN's
LAYERS_DE = tuple(f"{stack} layer {k}" for stack in STACKS_F for k in (0, 1))


def launch_counts(gk):
    """Every kernel's launch count."""
    return {k: getattr(gk, name).launches for k, name in {**COUNTERS, **TRAIN_WRAPPERS}.items()}


def zero_counts(gk):
    for name in {**COUNTERS, **TRAIN_WRAPPERS}.values():
        getattr(gk, name).launches = 0


def record_calls(module, names, run, keep_counts=False):
    """``run()`` with the functions ``names`` of ``module`` recorded: the
    ``(args, kwargs)`` of each call, in order, i.e. the main path's own inputs
    for each kernel wrapper. Not a main-path run (counts are reset later),
    unless ``keep_counts``: then the launches the wrappers counted while the
    recorders stood in their place go back to them."""
    seen = {name: [] for name in names}
    real = {name: getattr(module, name) for name in names}

    def rec(name):
        # wraps copies the wrapper's launch count, which the wrapper reaches
        # through its module's name while the recorder stands there
        @functools.wraps(real[name])
        def wrapped(*args, **kw):
            seen[name].append((args, kw))
            return real[name](*args, **kw)
        return wrapped

    stand_ins = {name: rec(name) for name in names}
    for name in names:
        setattr(module, name, stand_ins[name])
    try:
        run()
    finally:
        for name in names:
            setattr(module, name, real[name])
            if keep_counts:
                real[name].launches = stand_ins[name].launches
    torch.cuda.synchronize()
    return seen


def capture_kernel_args(sf, cfg, model, noisy):
    """The arguments that kernels A, B and C received in one serving forward
    (by key, for those that launched)."""
    from spiking_fullsubnet_torch.models.spiking_fullsubnet import spiking_fullsubnet_apply
    seen = record_calls(sf, WRAPPERS.values(), lambda: spiking_fullsubnet_apply(
        cfg, model.param_tree(), model.state_tree(), noisy))
    return {k: seen[name][-1] for k, name in WRAPPERS.items() if seen[name]}


def capture_f_args(gk, forward, x):
    """The positional arguments of each kernel-F launch of ``forward(x)``
    (``ops/gsu.gsu_stack_apply`` looks the wrapper up at each call)."""
    return [args for args, _ in record_calls(gk, ["gsu_stack_eval_x"],
                                             lambda: forward(x))["gsu_stack_eval_x"]]


def spike_mismatch(got, ref):
    return (got.float() != ref.float()).float().mean().item()


def rel_l2(got, ref):
    """Relative L2 error of a tensor, or of a (re, im) pair, against its
    reference."""
    if isinstance(got, torch.Tensor):
        got, ref = (got,), (ref,)
    num = sum((g.double() - r.double()).square().sum() for g, r in zip(got, ref))
    den = sum(r.double().square().sum() for r in ref)
    rel = (num / den).sqrt().item()
    require(np.isfinite(rel), "non-finite kernel output")
    return rel


def max_abs(got, ref):
    if isinstance(got, torch.Tensor):
        got, ref = (got,), (ref,)
    return max((g.double() - r.double()).abs().max().item() for g, r in zip(got, ref))


def as_f64_a(args):
    xg0, wihr, whh, coef, H, shared = args
    return (xg0.double(), wihr.double(), whh.double(), coef.double(), H, shared)


def as_f64_b(args):
    secs, *tensors, H, shared, beta = args
    f64 = lambda v: v.double() if isinstance(v, torch.Tensor) else v  # noqa: E731
    secs = [{k: f64(v) for k, v in s.items()} for s in secs]
    return (secs, *[f64(t) for t in tensors], H, shared, f64(beta))


def head_b(args, steps):
    """Kernel B's inputs cut to the first ``steps`` frames (a per-frame
    alpha and beta too)."""
    secs, xa, xb, alpha, sre, sim, H, shared, beta = args
    cut = lambda t: None if t is None else t[:steps].contiguous()  # noqa: E731
    return (secs, cut(xa), cut(xb), cut(alpha) if alpha is not None and alpha.ndim == 3 else alpha,
            cut(sre), cut(sim), H, shared, cut(beta))


def without_df(args):
    """Kernel B's inputs in its mode without the deep filter: the spectrum
    left out, each section's projection out."""
    secs, xa, xb, alpha, _, _, H, shared, beta = args
    return (secs, xa, xb, alpha, None, None, H, shared, beta)


def as_f64_c(args):
    mono, chunks = args
    f64 = lambda v: v.double() if isinstance(v, torch.Tensor) else v  # noqa: E731
    mono = {k: f64(v) for k, v in mono.items()}
    mono["fb"] = {k: f64(v) for k, v in mono["fb"].items()}
    mono["secs"] = [{k: f64(v) for k, v in sec.items()} for sec in mono["secs"]]
    return mono, chunks.double()


def as_f64_f(args):
    *tensors, H, shared = args
    return (*[t.double() for t in tensors], H, shared)


def head_c(args, steps):
    """Kernel C's inputs cut to the first ``steps`` steps."""
    mono, chunks = args
    return mono, chunks[:steps + 3].contiguous()


def tensors_of(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors_of(v)]
    return []


def bound_a(args, spikes, collect_all=False):
    """(bytes, operations, operation seconds) of kernel A's function on
    these inputs (``[(U,) T, R, G]``; with ``collect_all`` every layer's
    spikes written); ``spikes`` are the plain version's per-layer counts."""
    xg0, wihr, whh, coef, H, shared = args
    G = xg0.shape[-1]
    rows = xg0.numel() // G  # (U) T R row-steps
    L = whh.shape[0]
    es = xg0.element_size()
    n_out = L if collect_all else 1
    nbytes = (xg0.numel() + wihr.numel() + whh.numel() + n_out * rows * H) * es
    nbytes += coef.numel() * 4
    # recurrent products take every layer's spikes, inter-layer ones all but the last's
    mm = 2.0 * G * (sum(spikes) + sum(spikes[:-1]))
    cell = float(CELL_OPS) * L * rows * H
    return nbytes, mm + cell, mm / PEAK_OPS[xg0.dtype] + cell / PEAK_OPS[torch.float32]


def bound_f(args, spikes):
    """(bytes, operations, operation seconds) of kernel F's function on
    these inputs; ``spikes`` are the plain version's per-layer counts. The
    layer-0 product is dense (the raw features are real-valued)."""
    x, wih0, wihr, whh, coef, H, shared = args
    T, R, Fin = x.shape
    L, G = whh.shape[0], whh.shape[2]
    es = x.element_size()
    nbytes = (x.numel() + wih0.numel() + wihr.numel() + whh.numel() + L * T * R * H) * es
    nbytes += coef.numel() * 4
    mm = 2.0 * T * R * Fin * G + 2.0 * G * (sum(spikes) + sum(spikes[:-1]))
    cell = float(CELL_OPS) * L * T * R * H
    return nbytes, mm + cell, mm / PEAK_OPS[x.dtype] + cell / PEAK_OPS[torch.float32]


def bound_b(args, spikes):
    """(bytes, operations, operation seconds) of kernel B's function in any
    of its modes; ``spikes`` holds each section's per-layer counts."""
    secs, xa, xb, alpha, sre, sim, H, shared, beta = args
    T, B, _ = xa.shape
    G = H if shared else 2 * H
    es = xa.element_size()
    df_mode = sre is not None
    W = sum(s["wa"].shape[0] * s["ctr"] for s in secs)
    # inputs read once: the streams, the unit scales (per utterance or per
    # frame, and the pre-LN means), the spectrum bins filtered, the weights
    nbytes = (xa.numel() + xb.numel()) * es
    nbytes += sum(t.numel() * 4 for t in (alpha, beta) if t is not None)
    if df_mode:
        nbytes += 2 * T * B * W * 4 + 2 * T * B * W * 4  # spectrum in, enhanced re/im out
    mm = f32 = 0.0
    for s, n_sp in zip(secs, spikes):
        n, L, P = s["wa"].shape[0], s["whh"].shape[0], s["wproj"].shape[1]
        nbytes += sum(s[k].numel() * s[k].element_size()
                      for k in ("wa", "wb", "wihr", "whh", "coef", "wproj", "bproj", "uv")
                      if k in s)
        if not df_mode:
            nbytes += n * T * B * P * es  # the projection out
        # layer 0 reads only the lanes a unit's unfold touches (nonzero rows
        # of its one-hot-scattered weights), not the dense window
        lanes = ((s["wa"] != 0).any(-1).sum() + (s["wb"] != 0).any(-1).sum()).item()
        mm += 2.0 * G * lanes * T * B
        mm += 2.0 * G * (sum(n_sp) + sum(n_sp[:-1])) + 2.0 * P * n_sp[-1]
        # the gates' scaling: alpha ck (one operation a gate), alpha ck -
        # beta u + v (four), none without alpha; the deep filter's complex taps
        scale = 0 if alpha is None else (4 if "uv" in s else 1)
        f32 += float(T) * B * n * (CELL_OPS * L * H + scale * G
                                    + (8 * s["df"] * s["ctr"] if df_mode else 0))
    return nbytes, mm + f32, mm / PEAK_OPS[xa.dtype] + f32 / PEAK_OPS[torch.float32]


def bound_c(args, spikes):
    """(bytes, operations, operation seconds) of kernel C's function;
    ``spikes`` holds the fullband stack's per-layer counts, then each
    section's."""
    mono, chunks = args
    S, B, hop = chunks.shape[0] - 3, chunks.shape[1], chunks.shape[2]
    T, n_fft = mono["t_real"], mono["n_fft"]
    F1 = n_fft // 2 + 1
    H, fb = mono["hidden"], mono["fb"]
    G = H if mono["shared"] else 2 * H
    Hf = fb["hidden"]
    Gf = Hf if mono["shared"] else 2 * Hf
    Fin, Pfb = fb["wa"].shape[0], fb["wproj"].shape[1]
    U = sum(s["wa"].shape[0] for s in mono["secs"])
    n_stats = {"raw": 0, "cum": 1, "ln": 2}[mono["norm"]]
    # audio in, enhanced audio out, every weight once
    nbytes = chunks.numel() * chunks.element_size() + S * B * hop * 4
    nbytes += sum(t.numel() * t.element_size() for t in tensors_of(mono))
    fb_sp = spikes[0]
    mm = (2.0 * S * B * n_fft * 2 * F1 + 2.0 * T * B * 2 * F1 * n_fft  # DFT, inverse DFT
          + 2.0 * S * B * Fin * Gf
          + 2.0 * Gf * (sum(fb_sp) + sum(fb_sp[:-1])) + 2.0 * Pfb * fb_sp[-1])
    f32 = float(S) * B * (CELL_OPS * len(fb_sp) * Hf + 6 * F1
                          + 2 * n_stats * (U + 1) * (F1 - 1 + Pfb))
    for s, n_sp in zip(mono["secs"], spikes[1:]):
        n, L, P = s["wa"].shape[0], s["whh"].shape[0], s["wproj"].shape[1]
        lanes = ((s["wa"] != 0).any(-1).sum() + (s["wb"] != 0).any(-1).sum()).item()
        mm += 2.0 * G * lanes * S * B
        mm += 2.0 * G * (sum(n_sp) + sum(n_sp[:-1])) + 2.0 * P * n_sp[-1]
        f32 += float(S) * B * n * (CELL_OPS * L * H + G * (1 + n_stats) + 8 * s["df"] * s["ctr"])
    return nbytes, mm + f32, mm / PEAK_OPS[chunks.dtype] + f32 / PEAK_OPS[torch.float32]


def a_extras(gk, args, kw):
    """Kernel A beside its time on ``args``: its plan and SM cycles a step
    in each phase (one profiled launch, gk.stack_profile), the time of
    packing its weights (gk.stack_pack, done at every launch and inside its
    time), and two launches bitwise equal."""
    xg0, wihr, whh, coef, H, shared = args
    prof = gk.stack_profile(*args, **kw)
    pack_ms = cuda_ms(lambda: gk.stack_pack(wihr, whh, H, shared), iters=2)
    first, again = gk.gsu_stack_eval(*args, **kw), gk.gsu_stack_eval(*args, **kw)
    torch.cuda.synchronize()
    same = torch.equal(first, again)
    del first, again
    what = f"gsu_stack_eval {tuple(xg0.shape)}{' collect_all' if kw.get('collect_all') else ''}"
    log(f"[timing] {what} plan {prof['plan']}; SM cycles a step: "
        + ", ".join(f"{k} {v:.0f}" for k, v in prof["cycles_per_step"].items())
        + f"; weight packing (stack_pack) {pack_ms:.3f} ms; two launches bitwise equal: {same}")
    require(same, f"kernel A {what}: two launches on the same inputs differ")
    return {"plan": prof["plan"], "cycles_per_step": prof["cycles_per_step"], "pack_ms": pack_ms,
            "bitwise_twice": same}


def b_extras(gk, args):
    """Kernel B beside its time on ``args``: its plan and SM cycles a step
    in each phase (one profiled launch, gk.sections_profile), the time of
    packing its weights (gk.sections_pack, done at every launch and inside
    its time), and two launches bitwise equal."""
    secs, H, shared = args[0], args[6], args[7]
    prof = gk.sections_profile(*args)
    pack_ms = cuda_ms(lambda: gk.sections_pack(secs, H, shared), iters=2)
    first, again = gk.gsu_sections_eval(*args), gk.gsu_sections_eval(*args)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    del first, again
    p = prof["plan"]
    log(f"[timing] gsu_sections_eval {tuple(args[1].shape)} plan: {p['cols']} columns a block, "
        f"rows a tile {p['rows_per_tile']} by section, unit groups (section, first unit, units, "
        f"first block) {p['groups']}, {p['blocks']} blocks, {p['smem']} bytes of shared memory; "
        f"SM cycles a step: " + ", ".join(f"{k} {v:.0f}" for k, v in prof["cycles_per_step"].items())
        + f"; weight packing (sections_pack) {pack_ms:.3f} ms; two launches bitwise equal: {same}")
    require(same, "kernel B: two launches on the same inputs differ")
    return {"plan": p, "cycles_per_step": prof["cycles_per_step"], "pack_ms": pack_ms,
            "bitwise_twice": same}


def kernel_f_entry(gk, f_args, f_plain_ms, f_spikes, launches, checks, forwards):
    """Kernel F's line: each launch of ``STACKS_F`` (bench-shape arguments
    captured from the main paths, spikes counted by the plain version) timed
    alone; ms, plain_ms and bound_ms are the sums over zoo M layered's four
    launches, cIRM-GSN's one launch stands beside them."""
    per = []
    for name, args, ms_plain, counts in zip(STACKS_F, f_args, f_plain_ms, f_spikes):
        ms = cuda_ms(lambda: gk.gsu_stack_eval_x(*args), iters=3)
        nbytes, ops, ops_s = bound_f(args, counts)
        per.append({"stack": name, "shape": list(args[0].shape), "ms": ms, "plain_ms": ms_plain,
                    "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ops_ms": ops_s * 1e3,
                    "bytes": nbytes, "ops": ops, "spikes": counts})
        per[-1]["bound_ms"] = max(per[-1]["bytes_ms"], per[-1]["ops_ms"])
        # its plan and phase profile (one profiled launch), the weight packing
        # (stack_x_pack, at every launch and inside its time), two launches
        prof = gk.stack_x_profile(*args)
        pack_ms = cuda_ms(lambda: gk.stack_x_pack(*args[1:4], *args[5:]), iters=2)
        first, again = gk.gsu_stack_eval_x(*args), gk.gsu_stack_eval_x(*args)
        torch.cuda.synchronize()
        same = torch.equal(first, again)
        del first, again
        per[-1].update(plan=prof["plan"], cycles_per_step=prof["cycles_per_step"],
                       pack_ms=pack_ms, bitwise_twice=same)
        log(f"[timing] gsu_stack_eval_x {name} {tuple(args[0].shape)}: {ms:.3f} ms, plain "
            f"{ms_plain:.1f} ms, bound {per[-1]['bound_ms']:.4f} ms "
            f"(bytes {per[-1]['bytes_ms']:.4f} ms, operations {per[-1]['ops_ms']:.4f} ms); plan "
            f"{prof['plan']}; SM cycles a step: "
            + ", ".join(f"{k} {v:.0f}" for k, v in prof["cycles_per_step"].items())
            + f"; weight packing (stack_x_pack) {pack_ms:.3f} ms; two launches bitwise equal: "
            f"{same}")
        require(same, f"kernel F {name}: two launches on the same inputs differ")
    zoo, cirm = per[:4], per[4]
    b_bytes = sum(p["bytes_ms"] for p in zoo)
    b_ops = sum(p["ops_ms"] for p in zoo)
    ms = sum(p["ms"] for p in zoo)
    glue = forwards["zoo M layered"]["ms"] - ms
    pack = sum(p["pack_ms"] for p in zoo)
    log(f"[timing] gsu_stack_eval_x, the four launches of a zoo-M layered forward: {ms:.3f} ms "
        f"(forward {forwards['zoo M layered']['ms']:.3f} ms, glue {glue:.3f} ms by subtraction; "
        f"their weight packing {pack:.3f} ms)")
    return {
        "name": "gsu_stack_eval_x", "route": "cuda",
        "source": "spiking_fullsubnet_torch/csrc/gsu_stack_eval_x.cu",
        "replaces": "spiking_fullsubnet_tpu/ops/gsu_pallas.py:756", "launches": launches["F"],
        "max_abs_err": checks["bfloat16"]["max_abs_err"], "ms": ms,
        "plain_ms": sum(p["plain_ms"] for p in zoo), "bound_ms": max(b_bytes, b_ops),
        "bound_by": "bytes" if b_bytes >= b_ops else "operations", "library_ms": None,
        "per_launch": zoo, "glue_ms": glue, "pack_ms": pack, "checks": checks,
        "cirm_gsn": dict(cirm, launches=launches["F cIRM-GSN"]),
    }


# f32 operations per unit, row and step beside the cell's: D's batch statistics
# and normalisation; E's recomputed cell, surrogate, BN and cell backward
BN_OPS, E_CELL_OPS = 8, 38


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def fresh(tree):
    """A trainable copy of a parameter tree."""
    return tree_map(lambda t: t.detach().clone().requires_grad_(True), tree)


def fwd_bwd(apply, cfg, params, state, noisy, clean, loss_fn=None):
    """``apply(train=True)``, the recipe's loss (``loss_fn(est, ref)``, the
    denoise loss unless given) and its backward, no optimizer step: (loss,
    new state); the gradients are in ``.grad``."""
    from spiking_fullsubnet_torch.recipes.denoise import denoise_loss
    for t in tensors_of(params):
        t.grad = None
    out = apply(cfg, params, state, noisy, train=True)
    loss = (loss_fn or (lambda est, ref: denoise_loss(est, ref)["loss"]))(out["enhanced_y"], clean)
    loss.backward()
    return loss.detach(), out["state"]


def capture_de_args(gk, run):
    """The positional arguments of each launch of kernels D and E in
    ``run()``, detached from autograd (D's xg is the gate product of
    trainable weights, and the checks must not build graphs through the
    plain versions); E's in D's order (E receives the xg that D read)."""
    seen = record_calls(gk, ["gsu_layer_train_fwd", "gsu_layer_train_bwd"], run)
    detach = lambda a: tuple(t.detach() if isinstance(t, torch.Tensor) else t  # noqa: E731
                             for t in a)
    d = [detach(a) for a, _ in seen["gsu_layer_train_fwd"]]
    e = [detach(a) for a, _ in seen["gsu_layer_train_bwd"]]
    return d, [next(x for x in e if x[0].data_ptr() == a[0].data_ptr()) for a in d]


def as_f64_d(args):
    *tensors, H, shared, mode = args
    return (*[t.double() for t in tensors], H, shared, mode)


def head_e(args, steps):
    return (*[t[:steps].contiguous() for t in args[:4]], *args[4:])


def e_errors(gk, args):
    """(largest relative L2, largest abs error) of kernel E's four outputs
    against its plain version on the same inputs, and the plain dxg."""
    got, ref = gk.gsu_layer_train_bwd(*args), gk.layer_train_bwd_plain(*args)
    torch.cuda.synchronize()
    return max(rel_l2(g, r) for g, r in zip(got, ref)), max_abs(got, ref), ref[0]


def d_step_errors(gk, args, y, stats):
    """Kernel D's membranes ``y`` and statistics ``stats`` (or its plain
    version's) held one step at a time: every step t recomputed at once in
    float64 from the layer's own y[t-1] (h = 0 and c = 0 before the first
    step), as ``_fwd_kernel`` steps. A rounding flip changes only the state
    the next step starts from, which this recompute takes as given, so the
    chaos that follows a flip cannot hide a fault. Returns (largest
    |y - step|; largest statistics error, the mean's in units of the step's
    standard deviation and the variance's relative to var + eps; the spikes
    whose sign differs from the step's; their largest |step membrane|)."""
    xg, whh, b2, bnp, H, shared, mode = args
    yd = y.double()
    zero = torch.zeros_like(yd[:1])
    c_prev = torch.cat([zero, yd[:-1]])
    pre = xg.double() + torch.cat([zero, (yd[:-1] >= 0).double()]) @ whh.double()
    b, p = b2.double(), bnp.double()
    f = torch.sigmoid((pre if shared else pre[..., :H]) + b[0])
    cy = f * c_prev + (1.0 - f) * ((pre if shared else pre[..., H:]) + b[1])
    del pre, c_prev
    stats_err = 0.0
    if mode == "bn":
        mean = cy.mean(1)
        var = (cy - mean[:, None]).square().mean(1)
        rstd = torch.rsqrt(var + gk.BN_EPS)
        step = (cy - mean[:, None]) * rstd[:, None] * p[0] + p[1]
        stats_err = max(((stats[:, 0].double() - mean).abs() * rstd).max().item(),
                        ((stats[:, 1].double() - var).abs() / (var + gk.BN_EPS)).max().item())
    elif mode == "affine":
        step = cy * p[0] + p[1]
    else:
        step = cy
    flips = (yd >= 0) != (step >= 0)
    n_flips = int(flips.sum().item())
    return ((yd - step).abs().max().item(), stats_err, n_flips,
            step[flips].abs().max().item() if n_flips else 0.0)


def f64_onset(out, ora):
    """Where a float32 or bf16-stream run of D (``out``, the kernel's or the
    plain version's) leaves the float64 run ``ora``: the first step whose
    spikes differ (None if none); the largest |y - y_f64| up to and with
    that step (its membranes while they share the float64 run's history,
    which bounds the float64 |y| of a spike that flips there); the float64
    run's largest |y| at the spikes that differ there (0 if none)."""
    differs = (out[0].float() != ora[0].float()).flatten(1).any(1)
    onset = int(differs.float().argmax()) if bool(differs.any()) else None
    stop = len(differs) if onset is None else onset + 1
    y_err = (out[1][:stop].double() - ora[1][:stop]).abs().max().item()
    near = 0.0
    if onset is not None:
        flips = out[0][onset].float() != ora[0][onset].float()
        near = ora[1][onset][flips].abs().max().item()
    return onset, y_err, near


def d_checks(gk, d_args):
    """Kernel D against its plain version at each recorded launch, whole
    sequence: the spike mismatch and the first step where any spike
    differs; each one held one step at a time (``d_step_errors``); where
    each one leaves a float64 run of the plain version (``f64_onset``; W_hh
    rounded to the stream type first, as both round it) and its spike
    drift from that run; the plain version's ms; two launches bitwise equal
    (required)."""
    rec = {k: [] for k in ("spike_mismatch", "first_diff_step", "step_y_err",
                           "plain_step_y_err", "step_stats_err", "plain_step_stats_err",
                           "step_flips", "step_flip_max_abs_y", "onset_f64",
                           "plain_onset_f64", "pre_onset_y_err", "plain_pre_onset_y_err",
                           "onset_max_abs_y", "drift_f64", "plain_drift_f64", "plain_ms",
                           "bitwise_twice")}
    for da in d_args:
        got = gk.gsu_layer_train_fwd(*da)
        rec["bitwise_twice"].append(all(torch.equal(a, b) for a, b in
                                        zip(got, gk.gsu_layer_train_fwd(*da))))
        require(rec["bitwise_twice"][-1],
                f"kernel D differs between two launches on the same inputs ({da[0].shape})")
        box = []
        rec["plain_ms"].append(cuda_ms(lambda: box.append(gk.layer_train_fwd_plain(*da)),
                                       warmup=0))
        ref = box[0]
        differs = (got[0] != ref[0]).flatten(1).any(1)
        rec["spike_mismatch"].append(spike_mismatch(got[0], ref[0]))
        rec["first_diff_step"].append(
            int(differs.float().argmax()) if bool(differs.any()) else None)
        y_err, s_err, n_flips, near = d_step_errors(gk, da, got[1], got[2])
        p_y_err, p_s_err, _, _ = d_step_errors(gk, da, ref[1], ref[2])
        for k, v in (("step_y_err", y_err), ("plain_step_y_err", p_y_err),
                     ("step_stats_err", s_err), ("plain_step_stats_err", p_s_err),
                     ("step_flips", n_flips), ("step_flip_max_abs_y", near)):
            rec[k].append(v)
        xg, whh, *rest = da
        ora = gk.layer_train_fwd_plain(*as_f64_d((xg, whh.to(xg.dtype), *rest)))
        onset, y_err, near = f64_onset(got, ora)
        p_onset, p_y_err, _ = f64_onset(ref, ora)
        for k, v in (("onset_f64", onset), ("plain_onset_f64", p_onset),
                     ("pre_onset_y_err", y_err), ("plain_pre_onset_y_err", p_y_err),
                     ("onset_max_abs_y", near)):
            rec[k].append(v)
        rec["drift_f64"].append(spike_mismatch(got[0], ora[0]))
        rec["plain_drift_f64"].append(spike_mismatch(ref[0], ora[0]))
        del got, box, ref, ora
    return rec


def e_checks(gk, e_args, steps=None):
    """Kernel E (and the dW kernel, on the plain version's dxg) against
    their plain versions at each recorded launch, on its first ``steps``
    steps or the whole sequence: relative L2 and largest abs error. With
    bf16 streams also each against a float64 run of the plain version
    (which does not round drg to bf16): ``rel_l2_f64``, ``plain_rel_l2_f64``,
    the largest over the four outputs. Two launches of E (with dW) bitwise
    equal (required)."""
    rec = {"rel_l2": [], "max_abs_err": 0.0, "dw_rel_l2": [], "dw_max_abs_err": 0.0,
           "dw_bitwise_twice": [], "rel_l2_f64": [], "plain_rel_l2_f64": [],
           "bitwise_twice": []}
    for ea in e_args:
        args = head_e(ea, steps) if steps else ea
        rel, err, dxg = e_errors(gk, args)
        rec["bitwise_twice"].append(all(torch.equal(a, b) for a, b in zip(
            gk.gsu_layer_train_bwd(*args), gk.gsu_layer_train_bwd(*args))))
        require(rec["bitwise_twice"][-1],
                f"kernel E differs between two launches on the same inputs ({args[0].shape})")
        rec["rel_l2"].append(rel)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if args[0].dtype == torch.bfloat16:
            got, ref = gk.gsu_layer_train_bwd(*args), gk.layer_train_bwd_plain(*args)
            ora = gk.layer_train_bwd_plain(*as_f64_d(args))
            rec["rel_l2_f64"].append(max(rel_l2(g, o) for g, o in zip(got, ora)))
            rec["plain_rel_l2_f64"].append(max(rel_l2(r, o) for r, o in zip(ref, ora)))
            del got, ref, ora
        got_w, ref_w = gk.gsu_train_dw(args[1], dxg), gk.train_dw_plain(args[1], dxg)
        rec["dw_bitwise_twice"].append(bool(torch.equal(got_w, gk.gsu_train_dw(args[1], dxg))))
        require(rec["dw_bitwise_twice"][-1],
                f"the dW kernel differs between two launches on the same inputs ({args[1].shape})")
        rec["dw_rel_l2"].append(rel_l2(got_w, ref_w))
        rec["dw_max_abs_err"] = max(rec["dw_max_abs_err"], max_abs(got_w, ref_w))
    return rec


def fired(y):
    """Spikes that feed a recurrent product: steps 0..T-2 of a layer."""
    return float((y[:-1] >= 0).sum().item())


def bound_d(args, spikes):
    """(bytes, operations, operation seconds) of kernel D's function: xg,
    W_hh and the spikes in the stream type, the rest float32; the spike
    products at the stream type's peak, the cell and BN arithmetic at
    float32's."""
    xg, whh, b2, bnp, H, shared, mode = args
    T, R, G = xg.shape
    es = xg.element_size()
    nbytes = ((xg.numel() + whh.numel() + T * R * H) * es
              + (b2.numel() + bnp.numel() + T * R * H + 2 * T * H) * 4)
    mm = 2.0 * G * spikes
    cell = float(CELL_OPS + BN_OPS) * T * R * H
    return nbytes, mm + cell, mm / PEAK_OPS[xg.dtype] + cell / PEAK_OPS[torch.float32]


def bound_e(args, spikes):
    """(bytes, operations, operation seconds) of kernel E's function, dW
    included: the recompute and dW take the fired spikes, dh = drg W^T is
    dense; xg, gout, W_hh and dxg in the stream type."""
    xg, y, gout, stats, whh, b2, bnp, H, shared, mode = args
    T, R, G = xg.shape
    es = xg.element_size()
    nbytes = ((xg.numel() + gout.numel() + whh.numel() + T * R * G) * es
              + (y.numel() + stats.numel() + b2.numel() + bnp.numel() + H * G + 4 * H) * 4)
    mm = 4.0 * G * spikes + 2.0 * T * R * G * H
    cell = float(E_CELL_OPS) * T * R * H
    return nbytes, mm + cell, mm / PEAK_OPS[xg.dtype] + cell / PEAK_OPS[torch.float32]


def bound_dw(y, dxg, spikes):
    H, G = y.shape[-1], dxg.shape[-1]
    nbytes = y.numel() * 4 + dxg.numel() * dxg.element_size() + H * G * 4
    ops = 2.0 * G * spikes
    return nbytes, ops, ops / PEAK_OPS[dxg.dtype]


def train_launches(n_de):
    """Each kernel's launches in one train step of a model of ``n_de`` GSU
    layers."""
    return {"A": 0, "B": 0, "C": 0, "F": 0, "D": n_de, "E": n_de, "dW": n_de}


def time_train(apply, cfg, params, state, noisy, clean, want, iters=2, loss_fn=None, sr=SR):
    """One counted warm-up step (every kernel's count set to 0 just before
    it, read just after, required to be ``want``), then ``iters`` more
    steps, each from the weights, optimizer state and BN state the step
    before left, with the forward (to the loss), the backward and the
    clip-and-AdamW step timed by CUDA events, the step's own peak memory
    beside them. A step is ``recipes/denoise.train_step``'s: the forward,
    ``loss_fn(enhanced_y, clean)`` (the denoise loss unless given), its
    backward, clipping by global norm 10 and AdamW. Every timed step's loss
    must be finite; every step's loss and gradient norm come back, and
    ``nonfinite_steps`` lists the steps (0 the warm-up) where either is not
    finite; ``audio_s_per_s`` counts ``noisy``'s samples at rate ``sr``."""
    from spiking_fullsubnet_torch.ops import gsu_kernels as gk
    from spiking_fullsubnet_torch.recipes.denoise import adamw, denoise_loss
    if loss_fn is None:
        loss_fn = lambda est, ref: denoise_loss(est, ref)["loss"]  # noqa: E731
    params = fresh(params)
    leaves = tensors_of(params)
    opt = adamw(leaves)
    box = [state]

    def step(ev):
        ev[0].record()
        opt.zero_grad(set_to_none=True)
        out = apply(cfg, params, box[0], noisy, train=True)
        loss = loss_fn(out["enhanced_y"], clean)
        ev[1].record()
        loss.backward()
        ev[2].record()
        norm = torch.nn.utils.clip_grad_norm_(leaves, 10.0)
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        box[0] = out["state"]
        return loss.item(), norm.item()

    events = lambda: [torch.cuda.Event(enable_timing=True) for _ in range(4)]  # noqa: E731
    counters = {**COUNTERS, **TRAIN_WRAPPERS}
    for name in counters.values():
        getattr(gk, name).launches = 0
    loss, norm = step(events())
    counts = {k: getattr(gk, name).launches for k, name in counters.items()}
    require(counts == want, f"train step {cfg.compute_dtype} {tuple(noisy.shape)}: "
                            f"launches {counts}, expected {want}")
    losses, norms = [loss], [norm]
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    ms = {"forward_ms": 0.0, "backward_ms": 0.0, "step_ms": 0.0}
    each = []
    for _ in range(iters):
        ev = events()
        loss, norm = step(ev)
        for i, k in enumerate(ms):
            ms[k] += ev[i].elapsed_time(ev[i + 1]) / iters
        each.append(ev[0].elapsed_time(ev[3]))
        losses.append(loss)
        norms.append(norm)
        require(np.isfinite(loss), f"non-finite training loss {losses}")
    total = sum(ms.values())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    bad = [i for i, (a, b) in enumerate(zip(losses, norms))
           if not (np.isfinite(a) and np.isfinite(b))]
    return dict(ms, total_ms=total, each_ms=each, audio_s_per_s=noisy.numel() / sr / total * 1e3,
                peak_gb=peak_gb, held_gb=held_gb, own_peak_gb=peak_gb - held_gb,
                launches=counts, losses=losses, grad_norms=norms, nonfinite_steps=bad)


def time_de_layers(gk, names, d_args, e_args, d_plain_ms, e_plain_ms, with_dw=True):
    """Kernels D, E (with its dW kernel) and dW alone at each recorded
    launch, beside their plain versions' ms, bounds and, for dW,
    torch.matmul on the same [H, (T-1) R] x [(T-1) R, G] product in the
    stream type; D's and E's plans and phase profiles (one profiled launch
    each, gk.train_profile: SM cycles a step in each phase). Returns {"D":
    rows, "E": rows, "dW": rows}."""
    per = {"D": [], "E": [], "dW": []}
    for i, (name, da, ea) in enumerate(zip(names, d_args, e_args)):
        y = ea[1]
        spikes = fired(y)
        dxg = gk.gsu_layer_train_bwd(*ea)[0]
        H, G = y.shape[-1], dxg.shape[-1]
        rows = {
            "D": (cuda_ms(lambda: gk.gsu_layer_train_fwd(*da), iters=3), d_plain_ms[i],
                  bound_d(da, spikes), None),
            "E": (cuda_ms(lambda: gk.gsu_layer_train_bwd(*ea), iters=3), e_plain_ms[i],
                  bound_e(ea, spikes), None),
        }
        if with_dw:
            hp = (y[:-1] >= 0).to(dxg.dtype).reshape(-1, H).T.contiguous()
            dx1 = dxg[1:].reshape(-1, G)
            split = gk.dw_split_plan(*y.shape, G, dxg.dtype)
            rows["dW"] = (cuda_ms(lambda: gk.gsu_train_dw(y, dxg), iters=3),
                          cuda_ms(lambda: gk.train_dw_plain(y, dxg), warmup=0),
                          bound_dw(y, dxg, spikes),
                          cuda_ms(lambda: torch.matmul(hp, dx1), iters=3))
            del hp, dx1
        prof = {"D": gk.train_profile("fwd", da), "E": gk.train_profile("bwd", ea)}
        for k, (ms, plain, (nbytes, ops, ops_s), lib) in rows.items():
            row = {"layer": name, "shape": list(da[0].shape), "ms": ms, "plain_ms": plain,
                   "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ops_ms": ops_s * 1e3,
                   "bytes": nbytes, "ops": ops, "spikes": spikes, "library_ms": lib}
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            if k == "dW":
                row["splits"], row["rows_per_split"] = split
            else:
                row["profile"] = prof[k]
            per[k].append(row)
        log(f"[timing] {name} {tuple(da[0].shape)} {str(da[0].dtype)[6:]}: " + "; ".join(
            f"{k} {per[k][-1]['ms']:.3f} ms (plain {per[k][-1]['plain_ms']:.1f}, bound "
            f"{per[k][-1]['bound_ms']:.4f}"
            + (f", matmul {per[k][-1]['library_ms']:.3f}, {per[k][-1]['splits']} splits of "
               f"{per[k][-1]['rows_per_split']} rows" if k == "dW" else "") + ")"
            for k in rows))
        for k in ("D", "E"):
            p = prof[k]
            log(f"[profile] {name} {k}: {p['blocks']} blocks of {p['units_per_block']} units, "
                f"{p['row_groups_per_batch']} row groups a batch, {p['smem']} bytes of shared "
                f"memory ({', '.join(p['in_shared_memory'])}); SM cycles a step: " + ", ".join(
                    f"{ph} {c:.0f}" for ph, c in p["cycles_per_step"].items()))
        del dxg
    return per


DE_META = {"D": ("gsu_layer_train_fwd", "gsu_train_fwd.cu", 226),
           "E": ("gsu_layer_train_bwd", "gsu_train_bwd.cu", 358),
           "dW": ("gsu_train_dw", "gsu_train_bwd.cu", 454)}


def sums_of(rows):
    out = {f: sum(p[f] for p in rows) for f in ("ms", "plain_ms", "bytes_ms", "ops_ms")}
    out["bound_ms"] = max(out["bytes_ms"], out["ops_ms"])
    out["bound_by"] = "bytes" if out["bytes_ms"] >= out["ops_ms"] else "operations"
    lib = [p["library_ms"] for p in rows]
    out["library_ms"] = None if None in lib else sum(lib)
    return out


def de_entries(per, checks, launches, tag="", beside=None):
    """The JSON entries of kernels D, E and dW from ``per`` (the main
    configuration's layers; ms, plain_ms and bound_ms are their sums),
    ``beside`` naming other configurations' rows to stand beside them."""
    entries = []
    for k, (name, src, line) in DE_META.items():
        t = sums_of(per[k])
        entry = {
            "name": name + tag, "route": "cuda", "source": f"spiking_fullsubnet_torch/csrc/{src}",
            "replaces": f"spiking_fullsubnet_tpu/ops/gsu_pallas.py:{line}",
            "launches": launches[k], "max_abs_err": checks[k]["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"], "per_launch": per[k],
            "checks": checks[k]}
        for label, (rows, n) in (beside or {}).items():
            if rows.get(k):
                entry[label] = dict(sums_of(rows[k]), launches=n[k], per_launch=rows[k])
        entries.append(entry)
    return entries


def check_d(tag, rec, names):
    """Phase 6's requirements on ``d_checks``, for every layer: every step
    to the plain version's rounding, flips at the threshold; and against a
    float64 run, the membranes up to and with the step where the spikes
    part from it within 3x (+1e-4) of the plain version's up to its own
    parting: a spike that flips there lies within that distance of the
    threshold. What follows is one draw of the chaos that the batch
    statistics spread over the rows, for the kernel and the plain version
    alike, so the spike drift is logged, not held."""
    for i, layer in enumerate(names):
        require(rec["step_y_err"][i] <= 3 * rec["plain_step_y_err"][i] + 1e-4
                and rec["step_stats_err"][i] <= 3 * rec["plain_step_stats_err"][i] + 1e-4
                and rec["step_flip_max_abs_y"][i] < 1e-3, f"kernel D {layer} {tag}: {rec}")
        require(rec["pre_onset_y_err"][i] <= 3 * rec["plain_pre_onset_y_err"][i] + 1e-4,
                f"kernel D {layer} {tag}: against a float64 run {rec}")


SECTION_STACKS = ("fullband", "section 0", "section 1", "section 2")


def recipe_de_checks(gk, tag, run):
    """Phase 6's checks of kernels D, E and dW on the arguments of one
    training step of a recipe (``run()``: its forward, loss and backward,
    eight GSU layers); see ``de_arg_checks``."""
    return de_arg_checks(gk, tag, *capture_de_args(gk, run))


def de_arg_checks(gk, tag, d, e, stacks=SECTION_STACKS):
    """Phase 6's checks of kernels D, E and dW on the arguments ``d`` and
    ``e`` of one training step, two GSU layers in each of ``stacks``: D
    whole sequences (``check_d``); E within relative L2 1e-3 on the first
    WINDOW frames (phase 6's limit on a training batch) and on whole
    sequences (its limit on the fixture); dW whole sequences within
    DW_F32_REL. Returns the records."""
    require(len(d) == len(e) == 2 * len(stacks),
            f"{tag}: {len(d)} launches of D and {len(e)} of E")
    names = tuple(f"{tag} {stack} layer {k}" for stack in stacks for k in (0, 1))
    rec = {"shapes": [list(a[0].shape) for a in d], "D": d_checks(gk, d),
           "E": e_checks(gk, e), "E_head": e_checks(gk, e, WINDOW)}
    log_d(tag, rec["shapes"], rec["D"])
    fmt = lambda v: "[" + ", ".join(f"{x:.3e}" for x in v) + "]"  # noqa: E731
    log(f"[separation] E {tag}: first {WINDOW} frames rel L2 {fmt(rec['E_head']['rel_l2'])}; "
        f"whole sequences {fmt(rec['E']['rel_l2'])}, max abs err "
        f"{rec['E']['max_abs_err']:.3e}; dW rel L2 {fmt(rec['E']['dw_rel_l2'])}")
    check_d(tag, rec["D"], names)
    for layer, head, whole, w in zip(names, rec["E_head"]["rel_l2"], rec["E"]["rel_l2"],
                                     rec["E"]["dw_rel_l2"]):
        require(head < 1e-3 and whole < 1e-3, f"kernel E {layer}: {rec['E_head']}, {rec['E']}")
        require(w < DW_F32_REL, f"dW kernel {layer}: {rec['E']}")
    return rec


def log_d(tag, shape, rec):
    fmt = lambda v: "[" + ", ".join("-" if x is None else f"{x:.3e}" for x in v) + "]"  # noqa: E731
    log(f"[stream] D {tag} {shape}: spike mismatch {fmt(rec['spike_mismatch'])}; each step "
        f"against one float64 step from its own y[t-1]: membranes kernel "
        f"{fmt(rec['step_y_err'])}, plain {fmt(rec['plain_step_y_err'])}; statistics kernel "
        f"{fmt(rec['step_stats_err'])}, plain {fmt(rec['plain_step_stats_err'])}; spikes of "
        f"the other sign {rec['step_flips']} with step |y| <= "
        f"{fmt(rec['step_flip_max_abs_y'])}; against a float64 run: "
        f"{onset_text(rec)}, spike drift kernel {fmt(rec['drift_f64'])}, plain "
        f"{fmt(rec['plain_drift_f64'])}; plain ms {fmt(rec['plain_ms'])}")


def onset_text(rec):
    fmt = lambda v: "[" + ", ".join("-" if x is None else f"{x:.3e}" for x in v) + "]"  # noqa: E731
    return (f"first step of other spikes kernel {rec['onset_f64']}, plain "
            f"{rec['plain_onset_f64']}; membranes up to it kernel "
            f"{fmt(rec['pre_onset_y_err'])}, plain {fmt(rec['plain_pre_onset_y_err'])}; "
            f"float64 |y| at the kernel's parting flips {fmt(rec['onset_max_abs_y'])}")


def step_grads(gk, apply, cfg, p, st, noisy, clean, bwd):
    """(loss, gradient leaves) of one step with kernel E's wrapper swapped
    for ``bwd``."""
    real = gk.gsu_layer_train_bwd
    gk.gsu_layer_train_bwd = bwd
    try:
        q = fresh(p)
        loss, _ = fwd_bwd(apply, cfg, q, st, noisy, clean)
    finally:
        gk.gsu_layer_train_bwd = real
    return loss, [t.grad for t in tensors_of(q)]


def grads_vs_plain_e(gk, apply, cfg, p, st, noisy, clean):
    """One step's gradients through the kernels against the same step with
    E (and so dW) swapped for E's plain version: the largest leaf's
    relative L2 and whether the losses are equal (the step is deterministic,
    so both see the same forward and the same gradient up to the first E)."""
    loss_k, g_k = step_grads(gk, apply, cfg, p, st, noisy, clean, gk.gsu_layer_train_bwd)
    loss_q, g_q = step_grads(gk, apply, cfg, p, st, noisy, clean, gk.layer_train_bwd_plain)
    rels = [rel_l2(a, b) for a, b in zip(g_k, g_q)]
    return {"vs_plain_backward": max(rels), "losses_equal": bool(torch.equal(loss_k, loss_q)),
            "leaves": len(rels)}


def grads_vs_f64_e(gk, apply, cfg, p, st, noisy, clean):
    """With bf16 streams: one step's gradients through the kernels and
    through E's plain version, each against the same step with E run in
    float64 (no bf16 rounding of drg inside the recurrence; its outputs
    return in the kernel's types): the largest leaf's relative L2 of each."""
    def e_f64(*args):
        out = gk.layer_train_bwd_plain(*as_f64_d(args))
        return (out[0].to(args[0].dtype),) + tuple(o.float() for o in out[1:])

    g = {name: step_grads(gk, apply, cfg, p, st, noisy, clean, bwd)[1] for name, bwd in (
        ("kernel", gk.gsu_layer_train_bwd), ("plain", gk.layer_train_bwd_plain),
        ("f64", e_f64))}
    return {who: max(rel_l2(a, o) for a, o in zip(g[who], g["f64"]))
            for who in ("kernel", "plain")}


def stream_phase(gk, apply, flag, flag_base, model, base, fix_noisy, fix_clean, tb_noisy,
                 tb_clean, dev):
    """Phase 7 (the module docstring): training on the stream path with
    bf16 streams. Returns the kernels line's bf16-stream entries of D, E
    and dW, the timed steps and the checks."""
    import tomllib

    from spiking_fullsubnet_torch.models.spiking_fullsubnet import build_separator
    bf16 = "bfloat16"
    flag_cfg = replace(flag_base, compute_dtype=bf16)
    zoo_cfg = replace(base, compute_dtype=bf16)
    l_args = tomllib.loads(BASELINE_L_TOML.read_text())["model"]["args"]
    big = build_separator(seed=0, device=dev, **l_args)
    l_cfg = replace(big["config"], scan_mode="auto", compute_dtype=bf16,
                    collect_layer_outputs=False)
    confs = {"flagship M": (flag_cfg, flag.param_tree(), flag.state_tree(), 8),
             "zoo M stream": (zoo_cfg, model.param_tree(), model.state_tree(), 8),
             "baseline L": (l_cfg, big["params"], big["state"], 10)}
    out = {"checks": {}}

    # (a) D, E and dW with bf16 streams against their plain versions:
    # flagship M's eight layers, baseline L's four section layers of 1024
    # and 1536 rows, recorded from one forward and backward each
    recorded = {}
    for name in ("flagship M", "baseline L"):
        cfg, p, st, n = confs[name]
        d, e = capture_de_args(gk, lambda: fwd_bwd(apply, cfg, fresh(p), st, tb_noisy, tb_clean))
        require(len(d) == len(e) == n, f"{name}: {len(d)} launches of D and {len(e)} of E")
        require(all(a[0].dtype == torch.bfloat16 for a in d), f"{name}: D's streams not bf16")
        if name == "baseline L":
            keep = [i for i, a in enumerate(d) if a[0].shape[1] >= 1024]
            require([d[i][0].shape[1] for i in keep] == [1024, 1024, 1536, 1536],
                    f"baseline L rows {[a[0].shape for a in d]}")
            d, e = [d[i] for i in keep], [e[i] for i in keep]
        recorded[name] = (d, e)
    names = {"flagship M": LAYERS_FLAGSHIP,
             "baseline L": tuple(f"baseline L section {s} layer {k}" for s in (0, 1)
                                 for k in (0, 1))}
    checks = {"D": {}, "E": {}}
    e_plain_ms = {}
    for name, (d, e) in recorded.items():
        rec = d_checks(gk, d)
        shape = [tuple(a[0].shape) for a in d]
        log_d(name, shape, rec)
        check_d(name, rec, names[name])
        erec = e_checks(gk, e)
        log(f"[stream] E {name} whole sequences rel L2 {erec['rel_l2']}, max abs err "
            f"{erec['max_abs_err']:.3e}; against float64 kernel {erec['rel_l2_f64']}, plain "
            f"{erec['plain_rel_l2_f64']}; dW rel L2 {erec['dw_rel_l2']}")
        # a drg within a float32 rounding of a bf16 midpoint rounds the other
        # way in the kernel than in the plain version: both are held against
        # float64, the kernel within 3x (+1e-5) of the plain version's error
        for i, layer in enumerate(names[name]):
            require(erec["rel_l2_f64"][i] <= 3 * erec["plain_rel_l2_f64"][i] + 1e-5
                    and erec["dw_rel_l2"][i] < 1e-3, f"kernel E bf16 {layer}: {erec}")
        checks["D"][name], checks["E"][name] = rec, erec
        e_plain_ms[name] = [cuda_ms(lambda: gk.layer_train_bwd_plain(*ea), warmup=0) for ea in e]
    checks["D"]["max_abs_err"] = max(max(checks["D"][n]["step_y_err"]) for n in recorded)
    checks["E"]["max_abs_err"] = max(checks["E"][n]["max_abs_err"] for n in recorded)
    checks["dW"] = {"rel_l2": checks["E"]["flagship M"]["dw_rel_l2"],
                    "max_abs_err": checks["E"]["flagship M"]["dw_max_abs_err"]}

    # (b) one step's gradients on the stream path through the kernels
    # against E's plain version: f32 streams as in phase 6; with bf16
    # streams the rounding of drg at a bf16 midpoint goes either way, so
    # there the kernel and the plain version are each held against E in
    # float64 (the kernel within 3x (+1e-5) of the plain version's error)
    for name in ("flagship M", "zoo M stream", "baseline L"):
        cfg, p, st, _ = confs[name]
        g = grads_vs_plain_e(gk, apply, replace(cfg, compute_dtype=None), p, st, fix_noisy,
                             fix_clean)
        log(f"[stream] {name} float32 one step through the kernels against E's plain version "
            f"on the same forward (losses equal: {g['losses_equal']}): largest gradient-leaf "
            f"rel L2 {g['vs_plain_backward']:.3e} over {g['leaves']} leaves")
        require(g["vs_plain_backward"] < 1e-2, f"{name}: gradients {g}")
        out["checks"][f"{name} grads_vs_plain"] = g
    cfg, p, st, _ = confs["flagship M"]
    g = grads_vs_f64_e(gk, apply, cfg, p, st, fix_noisy, fix_clean)
    log(f"[stream] flagship M bf16 one step, largest gradient-leaf rel L2 against E in float64: "
        f"kernel {g['kernel']:.3e}, plain {g['plain']:.3e}")
    require(g["kernel"] <= 3 * g["plain"] + 1e-5, f"flagship M bf16: gradients {g}")
    out["checks"]["flagship M bf16 grads_vs_f64_e"] = g

    # (c) the train steps at 64 x 6 s, bf16, each counted
    timed = {}
    for name, (cfg, p, st, n) in confs.items():
        t = time_train(apply, cfg, p, st, tb_noisy, tb_clean, train_launches(n),
                       iters=1 if name == "baseline L" else 2)
        timed[name] = t
        log(f"[timing] train step {name} (stream path) bf16 {TRAIN_B} x {TRAIN_SECONDS:g} s: "
            f"forward {t['forward_ms']:.3f} ms, backward {t['backward_ms']:.3f} ms, clip and "
            f"AdamW {t['step_ms']:.3f} ms, total {t['total_ms']:.3f} ms "
            f"({t['audio_s_per_s']:.1f} audio-s/s), own peak memory {t['own_peak_gb']:.2f} GB "
            f"({t['held_gb']:.2f} GB held before), launches {t['launches']}; losses "
            f"{t['losses']}, gradient norms {t['grad_norms']}, non-finite steps "
            f"{t['nonfinite_steps']}")
        torch.cuda.empty_cache()

    # (d) the kernels alone: flagship M's eight layers, baseline L's four
    d_f, e_f = recorded["flagship M"]
    per = time_de_layers(gk, names["flagship M"], d_f, e_f,
                         checks["D"]["flagship M"]["plain_ms"], e_plain_ms["flagship M"])
    d_l, e_l = recorded["baseline L"]
    per_l = time_de_layers(gk, names["baseline L"], d_l, e_l,
                           checks["D"]["baseline L"]["plain_ms"], e_plain_ms["baseline L"],
                           with_dw=False)
    lk = {k: timed["baseline L"]["launches"][k] for k in ("D", "E", "dW")}
    out["kernels"] = de_entries(per, checks, timed["flagship M"]["launches"],
                                tag=" (bf16 streams)",
                                beside={"baseline_l_sections_0_1": (per_l, lk)})
    out["training"] = timed
    out["checks"].update(d=checks["D"], e=checks["E"])
    return out


def snr_db(got, ref):
    ref, got = ref.double(), got.double()
    return 10.0 * np.log10(ref.square().sum().item() / max((got - ref).square().sum().item(),
                                                           1e-30))


def deep_filtered(sf, projs, args):
    """Kernel B's deep filter applied to its projection mode's outputs
    (``[n, T, B, P]`` per section) against the spectrum of ``args``: the
    enhanced (re, im) ``[T, B, W]``."""
    secs, sre, sim = args[0], args[4], args[5]
    er, ei, f0 = [], [], 0
    for s, proj in zip(secs, projs):
        w = proj.shape[0] * s["ctr"]
        a, b = sf._deep_filter_tmajor(proj, s["ctr"], s["df"], sre[:, :, f0:f0 + w],
                                      sim[:, :, f0:f0 + w], torch.float32)
        er.append(a)
        ei.append(b)
        f0 += w
    return torch.cat(er, dim=-1), torch.cat(ei, dim=-1)


def counted_run(gk, fn):
    """``fn()`` with every kernel's count set to 0 just before and read
    just after: (its result, the counts)."""
    counters = {**COUNTERS, **TRAIN_WRAPPERS}
    for name in counters.values():
        getattr(gk, name).launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: getattr(gk, name).launches for k, name in COUNTERS.items()}


def b_entry(name, mode, args, spikes, ms, plain_ms, launches, checks):
    """A kernels-line entry of kernel B in one of its modes."""
    nbytes, ops, ops_s = bound_b(args, spikes)
    b_bytes, b_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops_s * 1e3
    log(f"[timing] gsu_sections_eval ({mode}) {name} {tuple(args[1].shape)}: {ms:.3f} ms, "
        f"plain {plain_ms:.1f} ms, bound {max(b_bytes, b_ops):.4f} ms (bytes {b_bytes:.4f} ms, "
        f"operations {b_ops:.4f} ms)")
    return {"name": f"gsu_sections_eval ({mode})", "route": "cuda",
            "source": "spiking_fullsubnet_torch/csrc/gsu_sections_eval.cu",
            "replaces": "spiking_fullsubnet_tpu/ops/gsu_pallas.py:1174", "launches": launches,
            "max_abs_err": checks["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(b_bytes, b_ops), "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "library_ms": None, "bytes": nbytes, "ops": ops, "spikes": spikes, "config": name,
            "shape": list(args[1].shape), "checks": checks}


def modes_phase(gk, sf, model, flag, flag_base, base, quality_x, clean, noisy, dev):
    """Phase 8 (the module docstring): kernel B in its per-frame, pre-LN,
    raw and projection modes, B against C on the same models, the collect
    path, and their forwards timed at the bench shape. Returns the kernels
    line's entries, the timed forwards and the checks."""
    from spiking_fullsubnet_torch.models.presets import flagship_m
    from spiking_fullsubnet_torch.models.spiking_fullsubnet import (
        SpikingFullSubNet, separator_config, spiking_fullsubnet_apply)
    bf16 = "bfloat16"
    rng = np.random.default_rng(0)  # phase 3's bench batch again
    bench = torch.from_numpy(
        (rng.standard_normal((BENCH_B, int(BENCH_SECONDS * SR))) * 0.1).astype(np.float32)).to(dev)
    zoo = lambda **kw: replace(separator_config(shared_weights=True, bn=True, **kw),  # noqa: E731
                               scan_mode="auto", collect_layer_outputs=False)
    raw = flagship_m(seed=0, device=dev, scan_mode="auto", collect_layer_outputs=False,
                     use_pre_layer_norm_fb=False, use_pre_layer_norm_sb=False,
                     fb_output_activate_function="tanh")
    # the configurations that take kernel B in each mode (each misses the
    # monolith's gate): name -> (mode, model)
    confs = {
        "flagship M, fullband tanh": (
            "ln", SpikingFullSubNet(replace(flag_base, fb_output_activate_function="tanh"),
                                    flag.param_tree(), flag.state_tree())),
        "zoo M, cumulative norm, fdrc 0.4": (
            "cum", SpikingFullSubNet.from_npz(str(ZOO_M), zoo(norm_type="cumulative_laplace_norm",
                                                              fdrc=0.4), device=dev)),
        "flagship widths, no norm, fullband tanh": (
            "raw", SpikingFullSubNet(raw["config"], raw["params"], raw["state"])),
    }
    for name, (mode, m) in confs.items():
        require(sf.norm_mode(m.cfg) == mode and not sf.monolith_ok(m.cfg), f"{name}: {mode}")
    out = {"checks": {}, "kernels": [], "forwards": {}}
    fmt = lambda v: "[" + ", ".join(f"{x:.3e}" for x in v) + "]"  # noqa: E731

    # (a) kernel B in each mode against its plain version on the inputs its
    # path gives it, f32 and bf16: 1 x 2 s whole, the bench's first WINDOW
    # frames; "ln" over the whole bench against float64; the projection mode
    # (no caller) on the same inputs at WINDOW frames
    bench_args, plain_ms, b_spikes = {}, {}, {}
    for name, (mode, m) in confs.items():
        rec = {}
        for dt in (None, bf16):
            tag = dt or "float32"
            cfg = replace(m.cfg, compute_dtype=dt)
            q_args, _ = capture_kernel_args(sf, cfg, m, quality_x)["B"]
            got, ref = gk.gsu_sections_eval(*q_args), gk.sections_eval_plain(*q_args)
            torch.cuda.synchronize()
            r = {"rel_l2": rel_l2(got, ref), "max_abs_err": max_abs(got, ref)}
            b_args, _ = capture_kernel_args(sf, cfg, m, bench)["B"]
            require(b_args[3] is None if mode == "raw" else b_args[3].ndim == 3,
                    f"{name}: alpha {None if b_args[3] is None else tuple(b_args[3].shape)}")
            require((b_args[8] is not None) == (mode == "ln"), f"{name}: beta")
            bh = head_b(b_args, WINDOW)
            r["bench_head_rel_l2"] = rel_l2(gk.gsu_sections_eval(*bh), gk.sections_eval_plain(*bh))
            # the projection mode: on "ln"'s inputs against its plain version;
            # on every mode's, deep-filtered here, against the kernel's own
            # deep-filter mode (the same gates and spikes, so no flip between)
            ph = without_df(bh)
            proj = gk.gsu_sections_eval(*ph)
            if mode == "ln":
                r["proj_head_rel_l2"] = rel_l2(tuple(proj), tuple(gk.sections_eval_plain(*ph)))
            r["proj_vs_df_rel_l2"] = rel_l2(deep_filtered(sf, proj, bh), gk.gsu_sections_eval(*bh))
            del proj
            if mode == "ln" or dt:
                # one plain run over the whole bench: timed, its spikes
                # counted, and for "ln" held with the kernel against float64
                ms_p, counts, ref_b = plain_run(gk.sections_eval_plain, b_args)
                if mode == "ln":
                    got_b = gk.gsu_sections_eval(*b_args)
                    ora = gk.sections_eval_plain(*as_f64_b(b_args))
                    r.update(bench_drift_f64=rel_l2(got_b, ora), plain_drift_f64=rel_l2(ref_b, ora),
                             bench_vs_plain=rel_l2(got_b, ref_b))
                    del got_b, ora
                if dt:
                    bench_args[name], plain_ms[name], b_spikes[name] = b_args, ms_p, counts
                del ref_b
            log(f"[modes] B {mode} {tag} {name}: 1 x 2 s rel L2 {r['rel_l2']:.3e} (max abs err "
                f"{r['max_abs_err']:.3e}); bench first {WINDOW} frames {r['bench_head_rel_l2']:.3e}, "
                f"projection mode deep-filtered against the deep-filter mode "
                f"{r['proj_vs_df_rel_l2']:.3e}"
                + (f", against its plain version {r['proj_head_rel_l2']:.3e}" if mode == "ln" else "")
                + (f"; whole bench against float64 kernel {r['bench_drift_f64']:.3e}, plain "
                   f"{r['plain_drift_f64']:.3e} (kernel vs plain {r['bench_vs_plain']:.3e})"
                   if mode == "ln" else ""))
            require(r["rel_l2"] < 0.05 and r["bench_head_rel_l2"] < 0.05,
                    f"kernel B {mode} {tag}: {r}")
            # bf16 projections are rounded before this deep filter, f32 in the kernel's
            require(r["proj_vs_df_rel_l2"] < (1e-4 if dt is None else 1e-2),
                    f"kernel B projection mode {mode} {tag}: {r}")
            if mode == "ln":
                require(r["proj_head_rel_l2"] < 1e-3, f"kernel B projection mode {tag}: {r}")
            if mode == "ln":
                require(r["bench_drift_f64"] <= 3 * r["plain_drift_f64"] + 1e-3,
                        f"kernel B ln {tag}: drift {r}")
            rec[tag] = r
            del q_args, b_args, bh, ph
            torch.cuda.empty_cache()
        out["checks"][f"B {mode}"] = rec

    # (b) B against C on the same model: the two-launch path and the
    # monolith, f32, 1 x 12345 samples (tests/test_stream_forward.py:65-90's
    # bound for two formulations of one forward), and zoo M's cumulative norm
    # through B on the speech fixture, counted
    cum_cfg = zoo(norm_type="cumulative_laplace_norm")
    cum_model = SpikingFullSubNet.from_npz(str(ZOO_M), cum_cfg, device=dev)
    x = torch.from_numpy((np.random.default_rng(3).standard_normal((1, 12345)) * 0.1).astype(
        np.float32)).to(dev)
    for name, m in (("flagship M", flag), ("zoo M cumulative norm", cum_model)):
        cfg = replace(m.cfg, compute_dtype=None)
        require(sf.monolith_ok(cfg), f"{name}: the monolith's config")
        p, st = m.param_tree(), m.state_tree()
        two, c2 = counted_run(gk, lambda: sf._serve_two_launch(cfg, p, st, x)["enhanced_y"])
        mono, c1 = counted_run(gk, lambda: spiking_fullsubnet_apply(cfg, p, st, x)["enhanced_y"])
        snr = snr_db(two, mono)
        log(f"[modes] {name} f32 1 x 12345: two-launch (launches {c2}) against the monolith "
            f"(launches {c1}): SNR {snr:.2f} dB")
        require(c2 == {"A": 1, "B": 1, "C": 0, "F": 0} and c1 == {"A": 0, "B": 0, "C": 1, "F": 0},
                f"{name}: launches {c2}, {c1}")
        require(snr > 60.0, f"{name}: two-launch against the monolith SNR {snr} dB")
        out["checks"][f"{name} B vs C snr_db"] = snr

    cfg = replace(cum_cfg, compute_dtype=bf16)
    y, c = counted_run(gk, lambda: sf._serve_two_launch(
        cfg, cum_model.param_tree(), cum_model.state_tree(), quality_x)["enhanced_y"])
    gain = si_sdr_gain(y, clean, noisy)
    log(f"[quality] zoo M cumulative norm bf16 1 x 2 s through kernel B: SI-SDR gain {gain:.3f} "
        f"dB, launches {c}")
    require(gain > 8.0 and c == {"A": 1, "B": 1, "C": 0, "F": 0}, f"zoo M cum via B: {gain}, {c}")
    out["checks"]["zoo M cum via B gain_db"] = gain
    del cum_model

    # (c) each mode's own path, counted (bf16, 1 x 2 s)
    launches = {}
    for name, (mode, m) in confs.items():
        m.cfg = replace(m.cfg, compute_dtype=bf16)
        o, c = counted_run(gk, lambda: m(quality_x))
        y = o["enhanced_y"]
        log(f"[quality] {name} bf16 1 x 2 s (B {mode}): {tuple(y.shape)} finite "
            f"{bool(torch.isfinite(y).all())}, launches {c}")
        require(tuple(y.shape) == tuple(quality_x.shape) and bool(torch.isfinite(y).all()),
                f"{name}: enhanced audio shape/finite")
        require(c == {"A": 1, "B": 1, "C": 0, "F": 0}, f"{name}: launches {c}")
        launches[name] = c["B"]

    # (d) the collect path: zoo M with every layer's outputs (the config's
    # default), bf16, counted; the lists shaped as the layered forward's, their
    # spikes against the same forward on the plain versions
    col = SpikingFullSubNet(replace(base, collect_layer_outputs=True, compute_dtype=bf16),
                            model.param_tree(), model.state_tree())
    o, c = counted_run(gk, lambda: col(quality_x))
    gain = si_sdr_gain(o["enhanced_y"], clean, noisy)
    lay = spiking_fullsubnet_apply(replace(base, scan_mode="layered", collect_layer_outputs=True,
                                           compute_dtype=bf16), model.param_tree(),
                                   model.state_tree(), quality_x)
    shapes = lambda r: [[tuple(t.shape) for t in x] if isinstance(x, list) else tuple(x.shape)  # noqa: E731
                        for x in r["fb_all_layer_outputs"] + r["sb_all_layer_outputs"]]
    real = sf.gsu_stack_eval
    sf.gsu_stack_eval = gk.stack_eval_plain
    try:
        plain_o = col(quality_x)
    finally:
        sf.gsu_stack_eval = real
    spikes_of = lambda r: r["fb_all_layer_outputs"][1:-1] + [  # noqa: E731
        t for sec in r["sb_all_layer_outputs"] for t in sec[1:-1]]
    pairs = list(zip(spikes_of(o), spikes_of(plain_o)))
    mism = [spike_mismatch(a, b) for a, b in pairs]
    err = max(max_abs(a, b) for a, b in pairs)
    log(f"[quality] zoo M collect path bf16 1 x 2 s: SI-SDR gain {gain:.3f} dB, launches {c}, "
        f"lists {shapes(o)} (layered {shapes(lay)}); spike mismatch against the plain versions "
        f"{fmt(mism)}")
    require(gain > 8.0, f"collect path SI-SDR gain {gain} dB")
    require(c == {"A": 4, "B": 0, "C": 0, "F": 0}, f"collect path launches {c}")
    require(shapes(o) == shapes(lay), f"collect lists {shapes(o)} vs layered {shapes(lay)}")
    require(len(mism) == 8 and max(mism) < 1e-3, f"collect spikes vs plain {mism}")
    out["checks"]["collect"] = {"gain_db": gain, "launches": c, "spike_mismatch": mism,
                                "max_abs_err": err}
    del o, lay, plain_o, col, pairs

    # (e) timing at the bench shape, bf16: each path's forward (its own
    # launches counted in a warm-up that also records the kernels' inputs),
    # then the kernel alone in that mode, its plain version and bound
    flag_col = SpikingFullSubNet(replace(flag_base, collect_layer_outputs=True, compute_dtype=bf16),
                                 flag.param_tree(), flag.state_tree())
    runs = [("flagship M, collect", flag_col, {"A": 4, "B": 0, "C": 0, "F": 0})]
    runs += [(name, m, {"A": 1, "B": 1, "C": 0, "F": 0}) for name, (_, m) in confs.items()]
    a_args = None
    for name, m, want in runs:
        held_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        for k in COUNTERS.values():
            getattr(gk, k).launches = 0
        seen = record_calls(sf, ["gsu_stack_eval"], lambda: m(bench)["enhanced_y"])
        counts = {k: getattr(gk, w).launches for k, w in COUNTERS.items()}
        require(counts == want, f"{name} bench: launches {counts}, expected {want}")
        if m is flag_col:
            a_args = seen["gsu_stack_eval"]
        del seen
        fwd_ms = cuda_ms(lambda: m(bench)["enhanced_y"], iters=2, warmup=0)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        out["forwards"][name] = {"ms": fwd_ms, "audio_s_per_s": BENCH_B * BENCH_SECONDS / fwd_ms * 1e3,
                                 "peak_gb": peak_gb, "held_gb": held_gb,
                                 "own_peak_gb": peak_gb - held_gb, "launches": counts}
        log(f"[timing] forward {name} bf16 {BENCH_B} x {BENCH_SECONDS:g} s: {fwd_ms:.3f} ms "
            f"({out['forwards'][name]['audio_s_per_s']:.1f} audio-s/s), own peak memory "
            f"{peak_gb - held_gb:.2f} GB ({held_gb:.2f} GB held before), launches {counts}")
        torch.cuda.empty_cache()
    del flag_col

    # kernel A in the collect path's forms: the fullband stack (3-D) and the
    # three sections' units form [n, T, B, G], every layer collected
    per = []
    for i, (args, kw) in enumerate(a_args):
        ms = cuda_ms(lambda: gk.gsu_stack_eval(*args, **kw), iters=3)
        ms_p, counts, _ = plain_run(gk.stack_eval_plain, args, **kw)
        nbytes, ops, ops_s = bound_a(args, counts, kw.get("collect_all", False))
        row = {"stack": "fullband" if i == 0 else f"section {i - 1}", "shape": list(args[0].shape),
               "ms": ms, "plain_ms": ms_p, "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "ops_ms": ops_s * 1e3, "bytes": nbytes, "ops": ops, "spikes": counts,
               "library_ms": None}
        row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
        per.append(row)
        log(f"[timing] gsu_stack_eval collect_all {row['stack']} {tuple(args[0].shape)}: "
            f"{ms:.3f} ms, plain {ms_p:.1f} ms, bound {row['bound_ms']:.4f} ms")
        row.update(a_extras(gk, args, kw))
    del a_args
    t = sums_of(per)
    out["kernels"].append({
        "name": "gsu_stack_eval (collect path: 3-D fullband, 4-D units sections, collect_all)",
        "route": "cuda", "source": "spiking_fullsubnet_torch/csrc/gsu_stack_eval.cu",
        "replaces": "spiking_fullsubnet_tpu/ops/gsu_pallas.py:923",
        "launches": out["forwards"]["flagship M, collect"]["launches"]["A"],
        "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
        "config": "flagship M, collect", "per_launch": per,
        "checks": out["checks"]["collect"]})
    for name, (mode, _) in confs.items():
        args = bench_args[name]
        ms = cuda_ms(lambda: gk.gsu_sections_eval(*args), iters=3)
        out["kernels"].append(b_entry(name, mode, args, b_spikes[name], ms, plain_ms[name],
                                      launches[name], out["checks"][f"B {mode}"]["bfloat16"]))
    # the projection mode on the "ln" configuration's inputs: no caller
    args = without_df(bench_args["flagship M, fullband tanh"])
    ms = cuda_ms(lambda: gk.gsu_sections_eval(*args), iters=3)
    ms_p, counts, _ = plain_run(gk.sections_eval_plain, args)
    out["kernels"].append(b_entry("flagship M, fullband tanh", "ln, projection out", args, counts,
                                  ms, ms_p, 0, out["checks"]["B ln"]["bfloat16"]))
    del bench_args, args, bench
    torch.cuda.empty_cache()
    return out


FREEZE_RECIPE = ROOT / "recipes" / "intel_ndns" / "spiking_fullsubnet_freeze_phase"
# the trainer phase's synthetic datasets: (items, seconds, seed)
TRAINER_DATA = {"train_dataset": (128, 6.0, 0), "validate_dataset": (16, 6.0, 77),
                "test_dataset": (2, 6.0, 99)}


def trainer_config(save_dir, max_epochs):
    """baseline_m.toml's [meta], [trainer], [optimizer], [acoustics] and
    [model] with max_epochs changed, on SyntheticNoisyDataset at the
    recipe's batch sizes."""
    from spiking_fullsubnet_torch.runtime.config import toml_load
    base = toml_load(FREEZE_RECIPE / "baseline_m.toml")
    cfg = {k: base[k] for k in ("meta", "trainer", "optimizer", "acoustics", "model")}
    return synthetic_run(cfg, base, save_dir, max_epochs)


def synthetic_run(cfg, base, save_dir, max_epochs):
    """``cfg`` saving under ``save_dir`` with max_epochs changed and
    TRAINER_DATA's SyntheticNoisyDataset at ``base``'s batch sizes."""
    cfg["meta"]["save_dir"] = str(save_dir)
    cfg["trainer"]["args"]["max_epochs"] = max_epochs
    for name, (n, secs, seed) in TRAINER_DATA.items():
        cfg[name] = {"path": "spiking_fullsubnet_tpu.data.SyntheticNoisyDataset",
                     "args": {"num_samples": n, "duration": secs, "seed": seed,
                              "train": name == "train_dataset"},
                     "dataloader": base[name]["dataloader"]}
    return cfg


class TrainerProbe:
    """Wraps DenoiseTrainer's steps while the phase runs: each update's
    kernel launches (the counts' change from the start of its training step
    to the end of its optimizer update), its CUDA end event, its gradient
    norm; each validation or test batch's launches and host time; every
    epoch's losses; every validation score."""

    def __init__(self, cls, gk):
        self.cls, self.gk = cls, gk
        self.updates, self.evals, self.losses, self.scores, self.epochs = [], [], [], [], []
        self.real = {n: getattr(cls, n) for n in (
            "training_step", "optimizer_update", "validation_step", "training_epoch_end",
            "validate")}

    def counts(self):
        return launch_counts(self.gk)

    def __enter__(self):
        probe, real = self, self.real

        def training_step(trainer, *a):
            probe._before = probe.counts()
            return real["training_step"](trainer, *a)

        def optimizer_update(trainer, lr):
            norm = real["optimizer_update"](trainer, lr)
            end = None
            if trainer.device.type == "cuda":
                end = torch.cuda.Event(enable_timing=True)
                end.record()
            after = probe.counts()
            probe.updates.append({"epoch": trainer.state.epochs_trained + 1, "end": end,
                                  "norm": float(norm), "lr": lr,
                                  "launches": {k: after[k] - probe._before[k] for k in after}})
            return norm

        def validation_step(trainer, *a):
            before, t0 = probe.counts(), time.perf_counter()
            out = real["validation_step"](trainer, *a)
            after = probe.counts()
            probe.evals.append({"s": time.perf_counter() - t0,
                                "launches": {k: after[k] - before[k] for k in after}})
            return out

        def training_epoch_end(trainer, out):
            probe.losses += [v for row in out for v in row.values()]
            probe.epochs.append(trainer.state.epochs_trained)
            return real["training_epoch_end"](trainer, out)

        def validate(trainer, loaders):
            score = real["validate"](trainer, loaders)
            probe.scores.append(score)
            return score

        for name, fn in (("training_step", training_step), ("optimizer_update", optimizer_update),
                         ("validation_step", validation_step),
                         ("training_epoch_end", training_epoch_end), ("validate", validate)):
            setattr(self.cls, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.cls, name, fn)


def update_ms(probe):
    """(ms per update, each gap): a TrainerProbe's updates, from the end of
    one update to the end of the next within an epoch."""
    gaps = [a["end"].elapsed_time(b["end"]) for a, b in zip(probe.updates, probe.updates[1:])
            if a["epoch"] == b["epoch"]]
    return float(np.mean(gaps)), gaps


def trainer_phase(dev):
    """Phase 9 (see the module docstring); returns its numbers."""
    import shutil
    import tempfile

    from spiking_fullsubnet_torch.ops import gsu_kernels as gk
    from spiking_fullsubnet_torch.recipes.denoise import DenoiseTrainer
    from spiking_fullsubnet_torch.runtime import cli
    from spiking_fullsubnet_torch.runtime.config import toml_dump

    torch.set_grad_enabled(True)
    save_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_trainer_"))
    toml = save_dir / "trainer_smoke.toml"

    def run(*argv):
        return cli.main(["-C", str(toml), *argv, "--device", dev.type], recipe_dir=FREEZE_RECIPE)

    try:
        zero_counts(gk)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with TrainerProbe(DenoiseTrainer, gk) as probe:
            toml_dump(trainer_config(save_dir, 2), toml)
            first = run("-M", "train")
            epochs_first = list(probe.epochs)
            toml_dump(trainer_config(save_dir, 3), toml)
            resumed = run("-M", "train", "-R")
            epochs_resumed = probe.epochs[len(epochs_first):]
            n_scores = len(probe.scores)
            tested = run("-M", "test", "validate", "--ckpt_path", "best")
        torch.cuda.synchronize()
        peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
        launches = probe.counts()
        exp = save_dir / "trainer_smoke"
        ckpts = sorted(p.name for p in (exp / "checkpoints").iterdir())
        test_csv = sorted((exp / "metrics").glob(
            f"dl_0_epoch_{tested.state.epochs_trained}_*_mean.csv"))
        header = test_csv[-1].read_text().splitlines()[0].split(",") if test_csv else []

        require(all(np.isfinite(v) for v in probe.losses) and probe.losses,
                f"trainer losses {probe.losses}")
        norms = [u["norm"] for u in probe.updates]
        require(all(np.isfinite(v) for v in norms), f"trainer gradient norms {norms}")
        want_update, want_eval = train_launches(8), dict(train_launches(0), F=4)
        require(len(probe.updates) == 6 and all(u["launches"] == want_update
                                                for u in probe.updates),
                f"trainer updates {[u['launches'] for u in probe.updates]}, "
                f"expected 6 of {want_update}")
        require(all(e["launches"] == want_eval for e in probe.evals),
                f"trainer eval batches {[e['launches'] for e in probe.evals]}, "
                f"expected {want_eval}")
        # validation: one batch an epoch (3), the test's two, the re-validation's one
        require(len(probe.evals) == 6, f"trainer eval batches {len(probe.evals)}")
        require(launches == dict(train_launches(6 * 8), F=6 * 4),
                f"trainer phase launches {launches}")
        max_ckpts = first.max_num_checkpoints
        want_ckpts = ["best"] + [f"epoch_{e:04d}" for e in range(max(1, 4 - max_ckpts), 4)]
        require(ckpts == want_ckpts, f"trainer checkpoints {ckpts}, expected {want_ckpts}")
        require(epochs_first == [1, 2] and first.state.epochs_trained == 2,
                f"first run's epochs {epochs_first}")
        require(epochs_resumed == [3] and resumed.state.epochs_trained == 3,
                f"resumed run's epochs {epochs_resumed}, epochs_trained "
                f"{resumed.state.epochs_trained}")
        revalidated = probe.scores[-1]
        # best's own trainer_state.json holds the score it was saved for
        require(len(probe.scores) == n_scores + 1 and revalidated == tested.state.best_score,
                f"best re-validated {revalidated!r}, recorded {tested.state.best_score!r}")
        require({"si_sdr", "synops", "neuron_ops"} <= set(header), f"test CSV header {header}")

        loop_ms, gaps = update_ms(probe)
        val = [e["s"] * 1e3 for e in probe.evals[:3]]

        # the same update bare: train_step on one batch of the same shapes
        model = first.model
        batch = next(iter(cli._loaders(trainer_config(save_dir, 2)["train_dataset"])[0]))
        noisy, clean = (torch.from_numpy(b).to(dev) for b in batch[:2])
        bare = time_train(model["apply"], model["config"], tested.params, tested.model_state,
                          noisy, clean, train_launches(8))
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    out = {"ms_per_update": loop_ms, "update_gaps_ms": gaps, "bare_step_ms": bare["total_ms"],
           "host_overhead_ms": loop_ms - bare["total_ms"], "ms_per_validation_batch":
           float(np.mean(val)), "validation_batch_ms": val, "own_peak_gb": peak_gb,
           "launches": launches, "losses": probe.losses, "grad_norms": norms,
           "lrs": [u["lr"] for u in probe.updates], "scores": probe.scores,
           "best_score": tested.state.best_score, "checkpoints": ckpts, "test_csv": header,
           "bare": {k: v for k, v in bare.items() if k != "launches"}}
    log(f"[trainer] zoo M layered f32 via runtime.cli on {card_name()}: "
        f"{loop_ms:.3f} ms per update inside the trainer (64 x 6 s; gaps {gaps}), bare "
        f"train_step {bare['total_ms']:.3f} ms, host overhead {loop_ms - bare['total_ms']:.3f} "
        f"ms; {np.mean(val):.3f} ms per validation batch (16 x 6 s; {val}); own peak memory "
        f"{peak_gb:.2f} GB; launches {launches}; best {tested.state.best_score!r} "
        f"re-validated {revalidated!r}; checkpoints {ckpts}")
    return out


SFS_RECIPE = ROOT / "recipes" / "intel_ndns" / "spiking_fullsubnet"
VAL_B, VAL_SECONDS = 16, 6.0  # the recipes' validation batch


def fused_forward_checks(gk, dev):
    """Phase 10 (a): the fused forward at baseline_m.toml's [model.args]
    (flagship widths, pre-LN, f32, random weights from the recipe's seed).
    On the speech fixture (1 x 2 s) the kernel route against the fused plain
    version run on the card, and against scan_mode="layered" bit for bit;
    launches counted; one eval forward at the recipe's validation batch (16 x
    6 s) and one train step at 64 x 6 s timed."""
    from spiking_fullsubnet_torch.models.fused_forward import fused_forward_plain
    from spiking_fullsubnet_torch.models.spiking_fullsubnet import build, spiking_fullsubnet_apply
    from spiking_fullsubnet_torch.runtime.config import toml_load

    recipe = toml_load(SFS_RECIPE / "baseline_m.toml")
    bundle = build(seed=recipe["meta"]["seed"], device=dev, **recipe["model"]["args"])
    cfg, params, state = bundle["config"], bundle["params"], bundle["state"]
    require(cfg.scan_mode == "fused" and cfg.compute_dtype is None and cfg.norm_type is None,
            f"baseline_m.toml's model: {cfg}")
    clean, noisy = speech_fixture()
    x = torch.from_numpy(noisy[None]).to(dev)
    with torch.no_grad():
        zero_counts(gk)
        out = spiking_fullsubnet_apply(cfg, params, state, x)
        torch.cuda.synchronize()
        counts = launch_counts(gk)
        plain = fused_forward_plain(cfg, params, state, x)
        layered = spiking_fullsubnet_apply(replace(cfg, scan_mode="layered"), params, state, x)
    torch.cuda.synchronize()
    want_eval = dict(train_launches(0), F=4)
    require(counts == want_eval, f"fused eval forward launches {counts}, expected {want_eval}")
    spikes = lambda o: ([o["fb_all_layer_outputs"][k] for k in (1, 2)]  # noqa: E731
                        + [sec[k] for sec in o["sb_all_layer_outputs"] for k in (1, 2)])
    mism = [spike_mismatch(a, b) for a, b in zip(spikes(out), spikes(plain))]
    audio_rel = rel_l2(out["enhanced_y"], plain["enhanced_y"])
    require(max(mism) < 1e-3 and audio_rel < 0.05,
            f"fused kernel route against its plain version: spike mismatch per layer {mism}, "
            f"audio rel L2 {audio_rel}")
    same = all(torch.equal(a, b) for a, b in zip(
        tensors_of([out["enhanced_y"], out["enhanced_mag"], out["fb_all_layer_outputs"],
                    out["sb_all_layer_outputs"]]),
        tensors_of([layered["enhanced_y"], layered["enhanced_mag"],
                    layered["fb_all_layer_outputs"], layered["sb_all_layer_outputs"]])))
    require(same, "fused kernel route differs from scan_mode='layered'")
    gain = si_sdr_gain(out["enhanced_y"], clean, noisy)  # random weights: finite, not good
    del out, plain, layered

    # one eval forward at the recipe's validation batch, counted then timed
    rng = np.random.default_rng(0)
    xv = torch.from_numpy((rng.standard_normal((VAL_B, int(VAL_SECONDS * SR))) * 0.1).astype(
        np.float32)).to(dev)
    with torch.no_grad():
        zero_counts(gk)
        spiking_fullsubnet_apply(cfg, params, state, xv)
        torch.cuda.synchronize()
        eval_counts = launch_counts(gk)
        eval_ms = cuda_ms(lambda: spiking_fullsubnet_apply(cfg, params, state, xv), iters=2)
    require(eval_counts == want_eval, f"fused eval 16 x 6 s launches {eval_counts}")
    del xv
    # one train step at 64 x 6 s: forward, loss, backward, clip, AdamW
    _, _, tb_noisy, tb_clean = training_batches(dev)
    torch.set_grad_enabled(True)
    step = time_train(spiking_fullsubnet_apply, cfg, params, state, tb_noisy, tb_clean,
                      train_launches(8))
    require(not step["nonfinite_steps"], f"fused train step: {step}")
    del tb_noisy, tb_clean
    torch.cuda.empty_cache()
    out = {"spike_mismatch": mism, "audio_rel_l2": audio_rel, "bitwise_equal_layered": same,
           "eval_launches": counts, "si_sdr_gain_random_weights": gain,
           "eval_16x6s_ms": eval_ms, "train_64x6s": {k: v for k, v in step.items()}}
    log(f"[flagship] fused forward, baseline_m.toml widths f32 on {card_name()}: kernel route "
        f"against the fused plain version (1 x 2 s): spike mismatch per layer "
        f"{[f'{v:.2e}' for v in mism]}, audio rel L2 {audio_rel:.3e}; equal to layered bit for "
        f"bit: {same}; launches {counts}; eval 16 x 6 s {eval_ms:.3f} ms; train step 64 x 6 s "
        f"{step['total_ms']:.3f} ms (forward {step['forward_ms']:.3f}, backward "
        f"{step['backward_ms']:.3f}, clip and AdamW {step['step_ms']:.3f}), launches "
        f"{step['launches']}, own peak {step['own_peak_gb']:.2f} GB")
    return out


def gan_config(toml, save_dir, max_epochs):
    """A GAN recipe's TOML with max_epochs changed, on SyntheticNoisyDataset
    at the recipe's batch sizes."""
    from spiking_fullsubnet_torch.runtime.config import toml_load
    cfg = toml_load(toml)
    return synthetic_run(cfg, dict(cfg), save_dir, max_epochs)


class GanProbe:
    """Wraps GanDenoiseTrainer's steps while phase 10 runs: each update's
    launches (from the start of its generator step to the end of its last
    discriminator step), CUDA events around the generator and the
    discriminator steps, the host clock around the targets, the gradient
    norm, every discriminator's rate and, for each discriminator's first
    step, its tensors before and after; each validation or test batch's
    launches; every epoch's losses."""

    def __init__(self, cls, gk):
        self.cls, self.gk = cls, gk
        self.updates, self.evals, self.losses, self.epochs, self.disc_lrs = [], [], [], [], {}
        self.first_disc = {}
        self.real = {n: getattr(cls, n) for n in (
            "generator_step", "batch_mos", "discriminator_step", "validation_step",
            "training_epoch_end", "_log_step")}

    def __enter__(self):
        probe, real = self, self.real

        def ev():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        def generator_step(trainer, *a):
            u = {"epoch": trainer.state.epochs_trained + 1, "before": launch_counts(probe.gk),
                 "g0": ev()}
            out = real["generator_step"](trainer, *a)
            u["g1"] = ev()
            probe.updates.append(u)
            return out

        def batch_mos(trainer, *a):
            t0 = time.perf_counter()
            out = real["batch_mos"](trainer, *a)
            probe.updates[-1]["targets_ms"] = (time.perf_counter() - t0) * 1e3
            return out

        def discriminator_step(trainer, name, clean_mag, enh_mag, target, lr):
            u = probe.updates[-1]
            u.setdefault("d0", ev())
            probe.disc_lrs.setdefault(name, []).append(lr)
            params = trainer.disc_params[name]
            snap = lambda: [t.detach().clone() for t in tensors_of(params)]  # noqa: E731
            before = snap() if name not in probe.first_disc else None
            out = real["discriminator_step"](trainer, name, clean_mag, enh_mag, target, lr)
            if before is not None:
                probe.first_disc[name] = (before, snap())
            u["d1"] = ev()
            u["after"] = launch_counts(probe.gk)
            return out

        def validation_step(trainer, *a):
            before = launch_counts(probe.gk)
            out = real["validation_step"](trainer, *a)
            after = launch_counts(probe.gk)
            probe.evals.append({k: after[k] - before[k] for k in after})
            return out

        def training_epoch_end(trainer, out):
            probe.losses += [v for row in out for v in row.values()]
            probe.epochs.append(trainer.state.epochs_trained)
            return real["training_epoch_end"](trainer, out)

        def _log_step(trainer, grad_norm, lr):
            probe.updates[-1].update(norm=float(grad_norm), lr=lr)
            return real["_log_step"](trainer, grad_norm, lr)

        for name, fn in (("generator_step", generator_step), ("batch_mos", batch_mos),
                         ("discriminator_step", discriminator_step),
                         ("validation_step", validation_step),
                         ("training_epoch_end", training_epoch_end), ("_log_step", _log_step)):
            setattr(self.cls, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.cls, name, fn)

    def update_launches(self):
        return [{k: u["after"][k] - u["before"][k] for k in u["after"]} for u in self.updates]


def gan_phase(gk, dev):
    """Phase 10 (b) and (c): baseline_m_GAN.toml through runtime.cli.main
    (train, train -R, test on best) and baseline_m_dualGAN.toml (one epoch of
    two updates), on SyntheticNoisyDataset."""
    import shutil
    import tempfile

    from spiking_fullsubnet_torch.models.discriminator import discriminator_weights, spectral_layers
    from spiking_fullsubnet_torch.recipes.gan import GanDenoiseTrainer
    from spiking_fullsubnet_torch.runtime import cli
    from spiking_fullsubnet_torch.runtime.checkpoint import CheckpointManager
    from spiking_fullsubnet_torch.runtime.config import toml_dump, toml_load
    from spiking_fullsubnet_torch.runtime.optimization import get_exponential_schedule

    save_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_gan_"))

    def run(toml, recipe_dir, *argv):
        return cli.main(["-C", str(toml), *argv, "--device", dev.type], recipe_dir=recipe_dir)

    def uv_moved(probe, t):
        """Per discriminator of trainer t: whether every weight and every u
        and v moved over its first step, but fc2's u (one element, always 1
        after the power iteration's normalisation), known by its identity in
        the tree."""
        out = {}
        for name, (before, after) in probe.first_disc.items():
            params = t.disc_params[name]
            n = {id(w) for w in discriminator_weights(params)}
            fc2_u = id(spectral_layers(params)[-1]["u"])
            kinds = ["w" if id(x) in n else "fc2_u" if id(x) == fc2_u else "uv"
                     for x in tensors_of(params)]
            moved = [not torch.equal(a, b) for a, b in zip(before, after)]
            out[name] = {k: all(m for m, kk in zip(moved, kinds) if kk == k) for k in ("w", "uv")}
        return out

    try:
        torch.set_grad_enabled(True)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        toml = save_dir / "gan_smoke.toml"
        zero_counts(gk)
        with GanProbe(GanDenoiseTrainer, gk) as probe:
            toml_dump(gan_config(SFS_RECIPE / "baseline_m_GAN.toml", save_dir, 1), toml)
            first = run(toml, SFS_RECIPE, "-M", "train")
            moved = uv_moved(probe, first)
            epochs_first = list(probe.epochs)
            saved = CheckpointManager(save_dir / "gan_smoke" / "checkpoints").load(
                "latest", map_location="cpu")
            toml_dump(gan_config(SFS_RECIPE / "baseline_m_GAN.toml", save_dir, 2), toml)
            resumed = run(toml, SFS_RECIPE, "-M", "train", "-R")
            epochs_resumed = probe.epochs[len(epochs_first):]
            tested = run(toml, SFS_RECIPE, "-M", "test", "--ckpt_path", "best")
        torch.cuda.synchronize()
        peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
        launches = launch_counts(gk)
        exp = save_dir / "gan_smoke"
        test_csv = sorted((exp / "metrics").glob(
            f"dl_0_epoch_{tested.state.epochs_trained}_*_mean.csv"))
        header = test_csv[-1].read_text().splitlines()[0].split(",") if test_csv else []

        require(probe.losses and all(np.isfinite(v) for v in probe.losses),
                f"GAN losses {probe.losses}")
        norms = [u["norm"] for u in probe.updates]
        require(all(np.isfinite(v) for v in norms), f"GAN gradient norms {norms}")
        want_update, want_eval = train_launches(8), dict(train_launches(0), F=4)
        per_update = probe.update_launches()
        require(len(per_update) == 4 and all(c == want_update for c in per_update),
                f"GAN updates {per_update}, expected 4 of {want_update}")
        # validation: one batch in each of the two epochs; the test's two
        require(len(probe.evals) == 4 and all(e == want_eval for e in probe.evals),
                f"GAN eval batches {probe.evals}, expected 4 of {want_eval}")
        require(launches == dict(train_launches(4 * 8), F=4 * 4), f"GAN phase launches {launches}")
        require(moved == {"d": {"w": True, "uv": True}},
                f"the discriminator's weights, u and v over its first step: {moved}")
        require(sorted(saved) == ["disc_opt_states", "disc_params", "model_state", "opt_state",
                                  "params"] and list(saved["disc_params"]) == ["d"]
                and all(int(s["step"]) == 2 for s in
                        saved["disc_opt_states"]["d"]["state"].values())
                and len(saved["disc_opt_states"]["d"]["state"]) == len(
                    discriminator_weights(first.disc_params["d"])),
                f"epoch 1's checkpoint: {sorted(saved)}")
        require(epochs_first == [1] and epochs_resumed == [2]
                and resumed.state.epochs_trained == 2 and resumed.state.steps_trained == 4,
                f"GAN epochs {epochs_first} then {epochs_resumed}")
        require({"si_sdr", "synops", "neuron_ops"} <= set(header), f"GAN test CSV {header}")

        # ms per GAN update: end of one update to the end of the next, same
        # epoch; its split over the same updates (a run's first update also
        # pays the library's first calls)
        ups = probe.updates
        pairs = [(a, b) for a, b in zip(ups, ups[1:]) if a["epoch"] == b["epoch"]]
        gaps = [a["d1"].elapsed_time(b["d1"]) for a, b in pairs]
        split = {"generator_ms": [u["g0"].elapsed_time(u["g1"]) for u in ups],
                 "targets_ms": [u["targets_ms"] for u in ups],
                 "discriminator_ms": [u["d0"].elapsed_time(u["d1"]) for u in ups]}
        steady = [ups.index(b) for _, b in pairs]
        # the same generator step bare: on one training batch, outside the loop
        batch = next(iter(cli._loaders(gan_config(SFS_RECIPE / "baseline_m_GAN.toml", save_dir,
                                                  1)["train_dataset"])[0]))
        noisy, clean = (torch.from_numpy(b).to(dev) for b in batch[:2])
        lr = ups[0]["lr"]
        bare_ms = cuda_ms(lambda: tested.generator_step(noisy, clean, lr), iters=2)
        del noisy, clean

        # (c) the freeze phase's dual GAN: one epoch of two updates
        dual_toml = save_dir / "dual_smoke.toml"
        zero_counts(gk)
        with GanProbe(GanDenoiseTrainer, gk) as dprobe:
            toml_dump(gan_config(FREEZE_RECIPE / "baseline_m_dualGAN.toml", save_dir, 1),
                      dual_toml)
            dual = run(dual_toml, FREEZE_RECIPE, "-M", "train")
            dual_moved = uv_moved(dprobe, dual)
        dual_updates = dprobe.update_launches()
        require(len(dual_updates) == 2 and all(c == train_launches(8) for c in dual_updates),
                f"dual GAN updates {dual_updates}")
        require(dual_moved == {n: {"w": True, "uv": True} for n in ("d_sig", "d_bak")},
                f"dual GAN discriminators over their first step: {dual_moved}")
        # the rates the TOML asks for: ExponentialLR a step an epoch, the
        # epoch being the run's two updates
        dcfg = toml_load(dual_toml)
        sched = lambda name, opt: get_exponential_schedule(  # noqa: E731
            float(dcfg[opt]["args"]["lr"]),
            float(dcfg[f"lr_scheduler_{name}"]["args"]["gamma"]), 2)
        want_lrs = {n: [sched(n, f"optimizer_{n}")(k) for k in range(2)]
                    for n in ("d_sig", "d_bak")}
        require(dprobe.disc_lrs == want_lrs and all(v > 0 for lrs in want_lrs.values()
                                                    for v in lrs),
                f"dual GAN discriminator rates {dprobe.disc_lrs}, schedules {want_lrs}")
        g_lrs = [u["lr"] for u in dprobe.updates]
        want_g = [sched("g", "optimizer")(k) for k in range(2)]
        require(g_lrs == want_g, f"dual GAN generator rates {g_lrs}, schedule {want_g}")
        require(all(np.isfinite(v) for v in dprobe.losses) and dprobe.losses,
                f"dual GAN losses {dprobe.losses}")
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    loop_ms = float(np.mean(gaps))
    mean = {k: float(np.mean([v[i] for i in steady])) for k, v in split.items()}
    out = {"ms_per_gan_update": loop_ms, "update_gaps_ms": gaps, "split_ms": split,
           "split_mean_ms": mean, "bare_generator_step_ms": bare_ms, "own_peak_gb": peak_gb,
           "launches": launches, "per_update_launches": per_update, "eval_launches": probe.evals,
           "losses": probe.losses, "grad_norms": norms, "lrs": [u["lr"] for u in ups],
           "disc_lrs": probe.disc_lrs, "best_score": tested.state.best_score,
           "test_csv": header, "dual": {"launches": dual_updates, "disc_lrs": dprobe.disc_lrs,
                                        "generator_lrs": g_lrs, "losses": dprobe.losses}}
    log(f"[flagship] baseline_m_GAN.toml via runtime.cli on {card_name()}: {loop_ms:.3f} ms per "
        f"GAN update inside the trainer (64 x 6 s; gaps {gaps}), of which (the same "
        f"updates) generator step {mean['generator_ms']:.3f} ms, host targets "
        f"{mean['targets_ms']:.3f} ms, discriminator step {mean['discriminator_ms']:.3f} ms "
        f"(every update: {split}); the generator step bare "
        f"{bare_ms:.3f} ms; own peak memory {peak_gb:.2f} GB; launches {launches}; best "
        f"{tested.state.best_score!r}; dual GAN rates {dprobe.disc_lrs}, generator {g_lrs}")
    return out


# ------------------------------------------------------------------ phase 11: serving

STREAM_SECONDS = 10.0  # the flagship stream of phase 11 (a)
HOPS_TIMED = 512  # hops each ms-per-hop reading averages
EXPORT_SECONDS = 30.0  # the offline artifacts' input length
# the interior of a primed stream against the offline forward: the bound of
# tests/test_streaming.py:55-56 for the same two formulations while every
# spike agrees; where spikes flip (the per-hop products and the offline
# kernels sum in other orders, and over thousands of frames a membrane near
# 0 rounds the other way, the flip then moving its row), the JAX tests'
# allowance for sparse spike flips in the pre-LN flagship, a relative L2 of
# the audio under 0.05 (tests/test_tpu_kernels.py:240-242)
STREAM_ATOL = 2e-4
FLIP_REL_L2 = 0.05


def stream_run(step, state, audio, chunk, keep_h=False):
    """``audio [B, T]`` (T a multiple of ``chunk``) through ``step(state,
    chunk)``: (the enhanced samples, the final state, each step's spikes of
    every layer when ``keep_h``: fullband layers, then each section's)."""
    outs, spikes = [], []
    for i in range(0, audio.shape[-1], chunk):
        state, y = step(state, audio[:, i:i + chunk])
        outs.append(y)
        if keep_h:
            spikes.append([h for h, _ in state["fb"]]
                          + [h for sec in state["sb"] for h, _ in sec])
    return torch.cat(outs, dim=-1), state, spikes


def primed_stream(enh, x):
    """A primed stream of ``x [1, T]`` (``tests/test_streaming.py:43-56``):
    the state primed with ``x[:, :prime_len]``, the rest streamed hop by hop
    with zeros after it to flush the tail. Emission i estimates sample i -
    n_fft / 2. Returns (the estimate of x's samples ``[1, T]``, the
    stream's output, each step's spikes)."""
    cfg = enh.cfg
    pad, hop, T = cfg.n_fft // 2, cfg.hop_length, x.shape[-1]
    rest = x[:, enh.prime_len:]
    n = -(-(T + pad) // hop) * hop
    feed = torch.nn.functional.pad(rest, (0, n - rest.shape[-1]))
    out, _, spikes = stream_run(enh.step, enh.init_state(prime_samples=x[:, :enh.prime_len]),
                                feed, hop, keep_h=True)
    return out[:, pad:pad + T], out, spikes


def interior(stream_out, offline, cfg):
    """(the stream's interior, the offline forward's), aligned as
    tests/test_streaming.py does: emission m is OLA[m hop:(m + 1) hop], the
    offline output OLA[pad:]; one extra hop skipped at the start and two at
    the tail."""
    hop, pad = cfg.hop_length, cfg.n_fft // 2
    k0 = pad // hop + 1
    aligned = stream_out[:, k0 * hop:]
    n = min(aligned.shape[-1], offline.shape[-1] - hop) - 2 * hop
    return aligned[:, :n], offline[:, hop:hop + n]


def interior_check(what, stream_out, spikes, offline, layered, cfg):
    """The primed stream's interior against the offline forward: within
    STREAM_ATOL where every layer's spikes equal the layered forward's, else
    within FLIP_REL_L2; the flips per layer printed. Returns the numbers."""
    got, want = interior(stream_out, offline, cfg)
    err, rel = max_abs(got, want), rel_l2(got, want)
    flips = spike_flips(spikes, layered, cfg.fb_num_layers)
    bound = f"rel L2 < {FLIP_REL_L2} (spikes flipped)" if any(flips) else f"atol {STREAM_ATOL}"
    log(f"[serving] {what}: interior max abs err {err:.3e}, rel L2 {rel:.3e} (bound {bound}); "
        f"spike flips per layer against the layered forward {flips}")
    require(rel < FLIP_REL_L2 if any(flips) else err < STREAM_ATOL,
            f"{what}: interior max abs err {err}, rel L2 {rel}, flips {flips}")
    return {"interior_max_abs_err": err, "interior_rel_l2": rel, "spike_flips_per_layer": flips,
            "bound": bound}


def spike_flips(spikes, layered, n_fb):
    """Per layer, the share of spikes that differ between the stream (step t)
    and the offline layered forward (frame t): fullband layers, then each
    section's."""
    offline = layered["fb_all_layer_outputs"][1:1 + n_fb]
    for sec in layered["sb_all_layer_outputs"]:
        offline += sec[1:-1]
    T = min(len(spikes), offline[0].shape[0])
    return [(torch.stack([s[k] for s in spikes[:T]]) != offline[k][:T]).float().mean().item()
            for k in range(len(offline))]


def ms_per_hop(step, state, chunk_audio, hops):
    """Mean ms a hop of ``step`` over ``hops`` hops (CUDA events), after a
    warm-up of eight steps; the state threads through."""
    st = state
    for _ in range(8):
        st, _ = step(st, chunk_audio)
    steps = max(1, hops * 128 // chunk_audio.shape[-1])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(steps):
        st, _ = step(st, chunk_audio)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (steps * chunk_audio.shape[-1] // 128)


class OpCalls:
    """Records every call of a ``sfs_torch`` operator (a kernel launch) while
    active: (the operator, its arguments), for ``torch.library.opcheck``."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        calls = self.calls = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func.namespace == "sfs_torch":  # eval operators: no autograd formula
                    calls.append((func, tuple(a.detach() if isinstance(a, torch.Tensor) else a
                                              for a in args)))
                return func(*args, **(kwargs or {}))

        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)


def serving_phase(gk, dev):
    """Phase 11 (see the module docstring); returns its numbers."""
    import shutil
    import tempfile

    from spiking_fullsubnet_torch.models.presets import flagship_m
    from spiking_fullsubnet_torch.models.spiking_fullsubnet import (
        SpikingFullSubNet, separator_config, spiking_fullsubnet_apply)
    from spiking_fullsubnet_torch.runtime import cli
    from spiking_fullsubnet_torch.runtime.config import toml_dump
    from spiking_fullsubnet_torch.runtime.convert import flat_paths, load_npz, reference_state_dict
    from spiking_fullsubnet_torch.streaming import StreamingEnhancer, state_leaves
    from spiking_fullsubnet_torch.tools import export_serving as es

    torch.set_grad_enabled(False)
    smi = card_name()
    out = {}
    rng = np.random.default_rng(0)

    # (a) flagship M streaming, batch 1
    flag = flagship_m(seed=0, device=dev, scan_mode="auto", collect_layer_outputs=False)
    cfg, hop = flag["config"], flag["config"].hop_length
    x = torch.from_numpy((rng.standard_normal((1, int(STREAM_SECONDS * SR))) * 0.1).astype(
        np.float32)).to(dev)
    enh = StreamingEnhancer(cfg, flag["params"], flag["state"], batch_size=1, chunk_frames=1,
                            device=dev)
    zero_counts(gk)
    _, stream_out, spikes = primed_stream(enh, x)
    torch.cuda.synchronize()
    stream_launches = launch_counts(gk)
    require(not any(stream_launches.values()),
            f"the streaming step launched kernels {stream_launches}")
    offline = spiking_fullsubnet_apply(cfg, flag["params"], flag["state"], x)["enhanced_y"]
    layered = spiking_fullsubnet_apply(replace(cfg, scan_mode="layered"), flag["params"],
                                       flag["state"], x)
    agree = interior_check(f"flagship M stream 1 x {STREAM_SECONDS:.0f} s primed against the "
                           "offline forward (kernel C)", stream_out, spikes, offline, layered, cfg)
    del layered

    # the graph against the eager step over the whole stream, bit for bit
    feed = x[:, :x.shape[-1] // hop * hop]
    g_out, g_state, _ = stream_run(enh.step, enh.init_state(), feed, hop)
    e_out, e_state, _ = stream_run(enh.eager_step, enh.init_state(), feed, hop)
    torch.cuda.synchronize()
    same = torch.equal(g_out, e_out) and all(
        torch.equal(a, b) for a, b in zip(state_leaves(g_state), state_leaves(e_state)))
    log(f"[serving] flagship M graph against eager over {feed.shape[-1] // hop} hops: output and "
        f"final state equal bit for bit: {same}")
    require(same, "the graph step differs from the eager step")

    timing = {}
    for cf in (1, 4):
        e_cf = StreamingEnhancer(cfg, flag["params"], flag["state"], batch_size=1,
                                 chunk_frames=cf, device=dev)
        chunk = x[:, :cf * hop].contiguous()
        for name, step in (("graph", e_cf.step), ("eager", e_cf.eager_step)):
            ms = ms_per_hop(step, e_cf.init_state(), chunk, HOPS_TIMED)
            budget = hop / SR * 1e3
            timing[f"{name}_cf{cf}"] = {"streaming_ms_per_hop_b1": ms,
                                        "streaming_hop_budget_ms": budget,
                                        "streaming_realtime_ok": bool(ms < budget)}
            log(f"[serving] flagship M {name} chunk_frames {cf}: {ms:.4f} ms per hop "
                f"(mean of {HOPS_TIMED} hops, CUDA events) against the {budget} ms budget, "
                f"real time {ms < budget}; {smi}")
    out["flagship_stream"] = dict(agree, graph_equals_eager=same, launches=stream_launches,
                                  timing=timing)

    # (b) zoo M with the cumulative norm, streamed over the quality fixture
    zcfg = replace(separator_config(norm_type="cumulative_laplace_norm", shared_weights=True,
                                    bn=True), scan_mode="auto", collect_layer_outputs=False)
    zoo = SpikingFullSubNet.from_npz(str(ZOO_M), zcfg, device=dev)
    clean, noisy = speech_fixture()
    xq = torch.from_numpy(noisy[None]).to(dev)
    zenh = StreamingEnhancer(zcfg, zoo.param_tree(), zoo.state_tree(), device=dev)
    aligned, zout, zspikes = primed_stream(zenh, xq)
    gain = si_sdr_gain(aligned, clean, noisy)
    log(f"[serving] zoo M cumulative norm streamed over the speech fixture: SI-SDR gain "
        f"{gain:.3f} dB (bound > 8)")
    require(gain > 8.0, f"zoo M streamed gain {gain}")
    zlayered = spiking_fullsubnet_apply(replace(zcfg, scan_mode="layered"), zoo.param_tree(),
                                        zoo.state_tree(), xq)
    zagree = interior_check("zoo M cumulative stream against the served forward (kernel C)",
                            zout, zspikes, zoo(xq)["enhanced_y"], zlayered, zcfg)
    out["zoo_m_cum_stream"] = dict(zagree, gain_db=gain)

    # (c) the serving export of flagship M, batch 1
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_export_"))
    try:
        xe = torch.from_numpy((rng.standard_normal((1, int(EXPORT_SECONDS * SR))) * 0.1).astype(
            np.float32)).to(dev)
        exports = {}
        for mode, want in (("auto", {"C": 1}), ("fused", {"F": 4})):
            bundle = es.build_bundle(None, device=dev, scan_mode=mode,
                                     collect_layer_outputs=False)
            t0 = time.perf_counter()
            ep, _ = es.export_offline(bundle, 1, EXPORT_SECONDS, SR)
            path = tmp / f"offline_{mode}.pt2"
            torch.export.save(ep, str(path))
            secs = time.perf_counter() - t0
            live = es._Enhance(bundle)(xe)
            zero_counts(gk)
            loaded = es.roundtrip_check(path, (xe,), live)
            torch.cuda.synchronize()
            got = {k: v for k, v in launch_counts(gk).items() if v}
            log(f"[serving] export flagship M offline scan_mode={mode} 1 x {EXPORT_SECONDS:.0f} s:"
                f" exported and saved in {secs:.1f} s ({path.stat().st_size} bytes); loaded and "
                f"run: equal to the live graph at atol 0; its launches {got}")
            require(got == want, f"the {mode} artifact launched {got}, expected {want}")
            exports[mode] = {"export_s": secs, "bytes": path.stat().st_size, "launches": got}
            del loaded
        ep, senh, sstate, schunk = es.export_streaming(flag, 1, 1)
        spath = tmp / "streaming_step_b1_cf1.pt2"
        torch.export.save(ep, str(spath))
        restored = torch.export.load(str(spath)).module()
        st_live = st_art = sstate
        zero_counts(gk)
        for i in range(8):  # the state threads through the artifact
            c = x[:, i * hop:(i + 1) * hop].contiguous()
            st_live, y_live = senh.eager_step(st_live, c)
            st_art, y_art = restored(st_art, c)
            require(torch.equal(y_art, y_live) and all(
                torch.equal(a, b) for a, b in zip(state_leaves(st_art), state_leaves(st_live))),
                f"the streaming artifact differs from the live step at step {i}")
        torch.cuda.synchronize()
        s_launch = {k: v for k, v in launch_counts(gk).items() if v}
        require(not s_launch, f"the streaming artifact launched {s_launch}")
        log(f"[serving] export flagship M streaming step b1 cf1 ({spath.stat().st_size} bytes): "
            f"8 steps through the loaded artifact equal the live step at atol 0, no kernel "
            f"launched")
        exports["streaming"] = {"bytes": spath.stat().st_size}

        # opcheck on each operator at small shapes: the launches of narrow
        # models' forwards (A and B: the two-launch path; C: the monolith;
        # F: the layered forward)
        narrow = dict(fb_hidden_size=24, sb_hidden_size=16, collect_layer_outputs=False)
        two_launch = replace(separator_config(norm_type="offline_laplace_norm", bn=True,
                                              shared_weights=True), scan_mode="auto", **narrow)
        pre_ln = flagship_m(device="cpu", scan_mode="auto", **narrow)["config"]
        xs = x[:, :4000].contiguous()
        with OpCalls() as rec:
            for tcfg in (two_launch, pre_ln, replace(pre_ln, scan_mode="layered")):
                SpikingFullSubNet.from_init(tcfg, seed=1, device=dev)(xs)
        checked = {}
        for func, args in rec.calls:
            name = func.name().split("::")[1].split(".")[0]
            if name not in checked:
                torch.library.opcheck(func, args)
                checked[name] = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
        log(f"[serving] torch.library.opcheck passed on {sorted(checked)} at {checked}")
        require(sorted(checked) == ["gsu_sections_eval", "gsu_stack_eval", "gsu_stack_eval_x",
                                    "sfsb_monolith_serve"], f"opcheck covered {sorted(checked)}")
        exports["opcheck"] = sorted(checked)
        out["export"] = exports

        # (d) the reference-checkpoint import through the CLI
        tree = load_npz(str(ZOO_M), device="cpu")
        ckpt = tmp / "pytorch_model.bin"
        torch.save(reference_state_dict(tree["params"], tree["state"]), ckpt)
        toml = tmp / "import_smoke.toml"
        toml_dump(trainer_config(tmp, 1), toml)
        zero_counts(gk)
        t0 = time.perf_counter()
        tested = cli.main(["-C", str(toml), "-M", "test", "--torch_ckpt", str(ckpt),
                           "--device", dev.type], recipe_dir=FREEZE_RECIPE)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: v for k, v in launch_counts(gk).items() if v}
        ref = SpikingFullSubNet.from_npz(str(ZOO_M), tested.model_config, device=dev)
        got_p, want_p = flat_paths(tested.params), flat_paths(ref.param_tree())
        got_s, want_s = flat_paths(tested.model_state), flat_paths(ref.state_tree())
        equal = (got_p.keys() == want_p.keys() and got_s.keys() == want_s.keys()
                 and all(torch.equal(got_p[k], want_p[k]) for k in want_p)
                 and all(torch.equal(got_s[k], want_s[k]) for k in want_s))
        n_batches = TRAINER_DATA["test_dataset"][0]
        log(f"[serving] runtime.cli -M test --torch_ckpt (frozen generation, module. prefix) on "
            f"freeze_phase/baseline_m.toml, {n_batches} test batches in {secs:.1f} s: the "
            f"trainer's weights equal SpikingFullSubNet.from_npz's bit for bit: {equal}; "
            f"launches {launches}")
        require(equal, "the imported weights differ from from_npz's")
        require(launches == {"F": 4 * n_batches}, f"the import test run launched {launches}")
        out["import"] = {"weights_equal": equal, "launches": launches, "seconds": secs}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ------------------------------------------------------------------ phase 12: separation

WSJ0_RECIPES = ROOT / "recipes" / "wsj0-mix"
REVERB_RECIPE = ROOT / "recipes" / "reverb" / "spiking_fullsubnet"
SEP_SR, SEP_SECONDS = 8000, 4.0  # wsj0-mix: 8 kHz, WSJ0MixDataset's default crop
# the separation runs' SyntheticMixDataset sets: (items, seed)
SEP_DATA = {"train_dataset": (64, 0), "validate_dataset": (8, 77), "test_dataset": (2, 99)}
BASELINE_UPDATES = 2  # Conv-TasNet's and cIRM-LSTM's updates (one epoch)
REVERB_SR, REVERB_SECONDS = 16000, 4.5  # the scp utterances phase 12 (c) writes
# the REVERB run's utterances: train (two updates of 32), dev, evaluation
REVERB_DATA = {"tr": 64, "et_simu": 4, "et_real": 2}


def separation_config(recipe, save_dir, max_epochs, sizes=None):
    """``recipes/wsj0-mix/<recipe>/default.toml`` with max_epochs changed,
    validation and checkpoints every epoch, on SyntheticMixDataset (wsj0-mix
    is not in the repository) at the recipe's batch sizes: ``sizes`` items
    (SEP_DATA's by default) of SEP_SECONDS each."""
    from spiking_fullsubnet_torch.runtime.config import toml_load
    cfg = toml_load(WSJ0_RECIPES / recipe / "default.toml")
    cfg["meta"]["save_dir"] = str(save_dir)
    cfg["trainer"]["args"].update(max_epochs=max_epochs, validation_interval=1,
                                  save_ckpt_interval=1)
    for name, (n, seed) in (sizes or SEP_DATA).items():
        cfg[name] = {"path": "spiking_fullsubnet_tpu.data.wsj0_mix.SyntheticMixDataset",
                     "args": {"num_samples": n, "duration": SEP_SECONDS, "sr": SEP_SR,
                              "seed": seed, "is_train": name == "train_dataset"},
                     "dataloader": cfg[name]["dataloader"]}
    return cfg


def write_reverb_data(root):
    """REVERB-like scp data under ``root`` in tests/test_recipes_e2e.py:43-62's
    layout (wav/far_test/*_ch1.wav, wav/cln_test/*.wav, data/*.scp, Kaldi's
    "utt_id path" lines): Gaussian utterances of REVERB_SECONDS (0.1 rms,
    seed 12), each made reverberant by an exponentially decaying noise tail
    (0.4 s, T60 about 0.3 s). Returns the scp paths by set."""
    from scipy.signal import fftconvolve

    from spiking_fullsubnet_torch.dsp.io import save_wav
    rng = np.random.default_rng(12)
    far, cln, data = root / "wav" / "far_test", root / "wav" / "cln_test", root / "data"
    for d in (far, cln, data):
        d.mkdir(parents=True)
    n, n_ir = int(REVERB_SECONDS * REVERB_SR), int(0.4 * REVERB_SR)
    tail = np.exp(-6.9 * np.arange(n_ir) / (0.3 * REVERB_SR))
    scps, k = {}, 0
    for name, count in REVERB_DATA.items():
        rvb, dry = [], []
        for _ in range(count):
            y = (0.1 * rng.standard_normal(n)).astype(np.float32)
            h = 0.2 * rng.standard_normal(n_ir) * tail
            h[0] = 1.0
            wet = fftconvolve(y, h)[:n]
            save_wav(wet / np.abs(wet).max() * 0.5, far / f"utt{k}_ch1.wav", REVERB_SR)
            save_wav(y / np.abs(wet).max() * 0.5, cln / f"utt{k}.wav", REVERB_SR)
            rvb.append(f"utt{k} {far / f'utt{k}_ch1.wav'}")
            dry.append(f"utt{k} {cln / f'utt{k}.wav'}")
            k += 1
        scps[name] = data / f"{name}_1ch.scp"
        scps[name].write_text("\n".join(rvb) + "\n")
        scps[name + "_cln"] = data / f"{name}_cln.scp"
        scps[name + "_cln"].write_text("\n".join(dry) + "\n")
    return scps


def reverb_config(save_dir, scps):
    """``recipes/reverb/spiking_fullsubnet/default.toml`` with one epoch and
    its scp paths pointed at ``write_reverb_data``'s, ``[predict] mix_root``
    the wav root (as tiny_synthetic.toml sets it); its two
    ``[[test_dataset]]`` load back from ``toml_dump``'s file."""
    from spiking_fullsubnet_torch.runtime.config import toml_load
    cfg = toml_load(REVERB_RECIPE / "default.toml")
    cfg["meta"]["save_dir"] = str(save_dir)
    cfg["trainer"]["args"]["max_epochs"] = 1
    cfg["train_dataset"]["args"].update(rvb_scp_fpath=str(scps["tr"]),
                                        dry_scp_fpath=str(scps["tr_cln"]))
    cfg["validate_dataset"]["args"].update(rvb_scp_fpath=str(scps["et_simu"]),
                                           dry_scp_fpath=str(scps["et_simu_cln"]))
    sim, real = cfg["test_dataset"]
    sim["args"]["scp_fpath"] = str(scps["et_simu"])
    real["args"]["scp_fpath"] = str(scps["et_real"])
    cfg["predict"] = {"mix_root": str(Path(scps["tr"]).parent.parent / "wav")}
    return cfg


def probed_runs(probe, argvs, toml, recipe_dir, dev):
    """``runtime.cli.main`` on ``toml`` once for each argv in ``argvs``, the
    epochs each run trained (from ``probe``) beside its trainer."""
    from spiking_fullsubnet_torch.runtime import cli
    out = []
    for argv in argvs:
        seen = len(probe.epochs)
        t = cli.main(["-C", str(toml), *argv, "--device", dev.type], recipe_dir=recipe_dir)
        out.append((t, probe.epochs[seen:]))
    return out


def separation_phase(gk, dev):
    """Phase 12 (see the module docstring); returns its numbers."""
    import shutil
    import tempfile

    from spiking_fullsubnet_torch.data.wsj0_mix import SyntheticMixDataset
    from spiking_fullsubnet_torch.models.fused_forward import fused_forward_plain
    from spiking_fullsubnet_torch.models.spiking_fullsubnet import spiking_fullsubnet_apply
    from spiking_fullsubnet_torch.recipes.dereverb import DereverbTrainer, dereverb_loss
    from spiking_fullsubnet_torch.recipes.separation import SeparationTrainer, separation_loss
    from spiking_fullsubnet_torch.runtime import cli
    from spiking_fullsubnet_torch.runtime.config import toml_dump
    from spiking_fullsubnet_torch.runtime.registry import instantiate

    fmt = lambda v: "[" + ", ".join(f"{x:.4g}" for x in v) + "]"  # noqa: E731
    t_phase = time.perf_counter()
    smi = card_name()
    want_update, want_eval = train_launches(8), dict(train_launches(0), F=4)
    out = {}
    save_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_separation_"))
    try:
        # (a) the two-speaker Spiking-FullSubNet: its eval route against the
        # fused plain version, then the recipe through the CLI
        torch.set_grad_enabled(False)
        base = separation_config("spiking_fullsubnet", save_dir, 1)
        bundle = instantiate(base["model"]["path"], args={"seed": base["meta"]["seed"],
                                                          "device": dev} | base["model"]["args"])
        cfg, params, state = bundle["config"], bundle["params"], bundle["state"]
        require(cfg.num_spks == 2 and cfg.n_fft == 256 and cfg.fb_hidden_size == 320
                and cfg.sb_hidden_size == 224 and cfg.scan_mode == "layered",
                f"wsj0-mix/spiking_fullsubnet/default.toml's model: {cfg}")
        mix = torch.from_numpy(SyntheticMixDataset(1, SEP_SECONDS, SEP_SR, seed=5)[0][0][None]).to(
            dev)
        zero_counts(gk)
        got = spiking_fullsubnet_apply(cfg, params, state, mix)
        torch.cuda.synchronize()
        counts = launch_counts(gk)
        plain = fused_forward_plain(replace(cfg, scan_mode="fused"), params, state, mix)
        spikes = lambda o: ([o["fb_all_layer_outputs"][k] for k in (1, 2)]  # noqa: E731
                            + [sec[k] for sec in o["sb_all_layer_outputs"] for k in (1, 2)])
        mism = [spike_mismatch(a, b) for a, b in zip(spikes(got), spikes(plain))]
        audio_rel = rel_l2(got["enhanced_y"], plain["enhanced_y"])
        log(f"[separation] wsj0-mix/spiking_fullsubnet default.toml widths f32 on {smi}: eval "
            f"route 1 x {SEP_SECONDS:g} s against the fused plain version: spike mismatch per "
            f"layer {[f'{v:.2e}' for v in mism]}, audio rel L2 {audio_rel:.3e}, launches {counts}")
        require(counts == want_eval, f"two-speaker eval launches {counts}, expected {want_eval}")
        require(tuple(got["enhanced_y"].shape) == (1, 2, int(SEP_SECONDS * SEP_SR))
                and bool(torch.isfinite(got["enhanced_y"]).all()), "two-speaker eval audio")
        require(len(mism) == 8 and max(mism) < 1e-3 and audio_rel < 0.05,
                f"two-speaker eval route: spike mismatch {mism}, audio rel L2 {audio_rel}")
        # the eval forward timed whole, and kernel F's four launches alone
        forward = lambda x: spiking_fullsubnet_apply(cfg, params, state, x)  # noqa: E731
        eval_ms = cuda_ms(lambda: forward(mix), iters=3)
        f_ms = [cuda_ms(lambda a=a: gk.gsu_stack_eval_x(*a), iters=3)
                for a in capture_f_args(gk, forward, mix)]
        log(f"[separation] two-speaker eval forward 1 x {SEP_SECONDS:g} s: {eval_ms:.3f} ms, "
            f"kernel F's four launches {sum(f_ms):.3f} ms ({fmt(f_ms)}), the rest "
            f"{eval_ms - sum(f_ms):.3f} ms")
        out["eval_route"] = {"spike_mismatch": mism, "audio_rel_l2": audio_rel,
                             "launches": counts, "eval_ms": eval_ms, "f_ms": f_ms}
        del got, plain, bundle, params, state

        torch.set_grad_enabled(True)
        toml = save_dir / "wsj0_sfs_smoke.toml"
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(gk)
        with TrainerProbe(SeparationTrainer, gk) as probe:
            toml_dump(base, toml)
            (first, ep1), = probed_runs(probe, [["-M", "train"]], toml,
                                        WSJ0_RECIPES / "spiking_fullsubnet", dev)
            toml_dump(separation_config("spiking_fullsubnet", save_dir, 2), toml)
            (resumed, ep2), (tested, _) = probed_runs(
                probe, [["-M", "train", "-R"], ["-M", "test", "--ckpt_path", "best"]], toml,
                WSJ0_RECIPES / "spiking_fullsubnet", dev)
        torch.cuda.synchronize()
        peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
        launches = launch_counts(gk)
        exp = save_dir / "wsj0_sfs_smoke"
        test_csv = sorted((exp / "metrics").glob(
            f"dl_0_epoch_{tested.state.epochs_trained}_*_mean.csv"))
        header = test_csv[-1].read_text().splitlines()[0].split(",") if test_csv else []
        norms = [u["norm"] for u in probe.updates]
        n_val, n_test = SEP_DATA["validate_dataset"][0], SEP_DATA["test_dataset"][0]
        require(probe.losses and all(np.isfinite(v) for v in probe.losses + norms),
                f"two-speaker losses {probe.losses}, gradient norms {norms}")
        require(len(probe.updates) == 4 and all(u["launches"] == want_update
                                                for u in probe.updates),
                f"two-speaker updates {[u['launches'] for u in probe.updates]}")
        require(len(probe.evals) == 2 * n_val + n_test
                and all(e["launches"] == want_eval for e in probe.evals),
                f"two-speaker eval batches {[e['launches'] for e in probe.evals]}")
        require(launches == dict(train_launches(4 * 8), F=4 * (2 * n_val + n_test)),
                f"two-speaker phase launches {launches}")
        require(ep1 == [1] and ep2 == [2] and resumed.state.epochs_trained == 2,
                f"two-speaker epochs {ep1} then {ep2}")
        require("si_sdr" in header, f"two-speaker test CSV {header}")
        loop_ms, gaps = update_ms(probe)
        val = [e["s"] * 1e3 for e in probe.evals[:n_val]]
        # the same update bare, timed as phase 6, on one training batch
        batch = next(iter(cli._loaders(base["train_dataset"])[0]))
        noisy, ref = (torch.from_numpy(b).to(dev) for b in batch[:2])
        bare = time_train(tested.model_apply, tested.model_config, tested.params,
                          tested.model_state, noisy, ref, want_update, loss_fn=separation_loss,
                          sr=SEP_SR)
        require(not bare["nonfinite_steps"], f"two-speaker bare step {bare}")
        # D, E and dW against their plain versions at this recipe's shapes
        de = recipe_de_checks(gk, "two-speaker", lambda: fwd_bwd(
            tested.model_apply, tested.model_config, fresh(tested.params), tested.model_state,
            noisy, ref, loss_fn=separation_loss))
        del noisy, ref, first, resumed, tested
        out["spiking_fullsubnet"] = {"kernel_checks": de,
            "ms_per_update": loop_ms, "update_gaps_ms": gaps, "bare_step_ms": bare["total_ms"],
            "bare": {k: v for k, v in bare.items() if k != "launches"},
            "ms_per_validation_batch": float(np.mean(val)), "validation_batch_ms": val,
            "own_peak_gb": peak_gb, "launches": launches, "losses": probe.losses,
            "grad_norms": norms, "test_csv": header}
        log(f"[separation] wsj0-mix/spiking_fullsubnet via runtime.cli on {smi}: {loop_ms:.3f} "
            f"ms per update inside the trainer (32 x {SEP_SECONDS:g} s; gaps {gaps}), bare step "
            f"{bare['total_ms']:.3f} ms ({fmt(bare['each_ms'])}; forward "
            f"{bare['forward_ms']:.3f}, backward {bare['backward_ms']:.3f}, clip and AdamW "
            f"{bare['step_ms']:.3f}); "
            f"{np.mean(val):.3f} ms per validation batch (1 x {SEP_SECONDS:g} s); own peak "
            f"memory {peak_gb:.2f} GB; launches {launches}; losses {fmt(probe.losses)}")
        torch.cuda.empty_cache()

        # (b) the baselines: one epoch of two updates, then test
        for recipe in ("conv_tasnet", "cirm_lstm"):
            sizes = dict(SEP_DATA, validate_dataset=(2, 77))
            bcfg = separation_config(recipe, save_dir, 1, sizes)
            batch_size = bcfg["train_dataset"]["dataloader"]["batch_size"]
            sizes["train_dataset"] = (BASELINE_UPDATES * batch_size, 0)
            bcfg = separation_config(recipe, save_dir, 1, sizes)
            btoml = save_dir / f"{recipe}_smoke.toml"
            toml_dump(bcfg, btoml)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            zero_counts(gk)
            with TrainerProbe(SeparationTrainer, gk) as bprobe:
                (bt, bep), _ = probed_runs(bprobe, [["-M", "train"],
                                                    ["-M", "test", "--ckpt_path", "best"]],
                                           btoml, WSJ0_RECIPES / recipe, dev)
            torch.cuda.synchronize()
            bpeak = (torch.cuda.max_memory_allocated() - held) / 1e9
            blaunches = launch_counts(gk)
            bnorms = [u["norm"] for u in bprobe.updates]
            bms, bgaps = update_ms(bprobe)
            log(f"[separation] wsj0-mix/{recipe} via runtime.cli on {smi}: {bms:.3f} ms per "
                f"update inside the trainer ({batch_size} x {SEP_SECONDS:g} s; gaps {bgaps}); "
                f"own peak memory {bpeak:.2f} GB; launches {blaunches}; losses "
                f"{fmt(bprobe.losses)}, gradient norms {fmt(bnorms)}")
            require(bep == [1] and len(bprobe.updates) == BASELINE_UPDATES,
                    f"{recipe}: epochs {bep}, updates {len(bprobe.updates)}")
            require(bprobe.losses and all(np.isfinite(v) for v in bprobe.losses + bnorms),
                    f"{recipe}: losses {bprobe.losses}, gradient norms {bnorms}")
            require(not any(blaunches.values()), f"{recipe} launched kernels {blaunches}")
            out[recipe] = {"ms_per_update": bms, "update_gaps_ms": bgaps, "own_peak_gb": bpeak,
                           "launches": blaunches, "losses": bprobe.losses, "grad_norms": bnorms,
                           "batch": batch_size, "params": sum(w.numel() for w in bt.weights)}
            del bt
            torch.cuda.empty_cache()

        # (c) REVERB: train two updates, then predict on best
        scps = write_reverb_data(save_dir / "reverb")
        rcfg = reverb_config(save_dir, scps)
        rtoml = save_dir / "reverb_smoke.toml"
        toml_dump(rcfg, rtoml)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(gk)
        with TrainerProbe(DereverbTrainer, gk) as rprobe:
            (rt, rep), = probed_runs(rprobe, [["-M", "train"]], rtoml, REVERB_RECIPE, dev)
        torch.cuda.synchronize()
        rpeak = (torch.cuda.max_memory_allocated() - held) / 1e9
        train_counts = launch_counts(gk)
        zero_counts(gk)
        cli.main(["-C", str(rtoml), "-M", "predict", "--ckpt_path", "best", "--device", dev.type],
                 recipe_dir=REVERB_RECIPE)
        torch.cuda.synchronize()
        predict_counts = launch_counts(gk)
        # D, E and dW against their plain versions at REVERB's shapes
        rbatch = next(iter(cli._loaders(rcfg["train_dataset"], REVERB_RECIPE)[0]))
        rx, rref = (torch.from_numpy(b).to(dev) for b in rbatch[:2])
        rde = recipe_de_checks(gk, "REVERB", lambda: fwd_bwd(
            rt.model_apply, rt.model_config, fresh(rt.params), rt.model_state, rx, rref,
            loss_fn=lambda est, ref: dereverb_loss(est, ref)["loss"]))
        del rx, rref
        rnorms = [u["norm"] for u in rprobe.updates]
        rms, rgaps = update_ms(rprobe)
        rval = [e["s"] * 1e3 for e in rprobe.evals]
        enhanced = rt.enhanced_dir
        wavs = {d.name: sorted(p.relative_to(d).as_posix() for p in d.rglob("*.wav"))
                for d in sorted(enhanced.iterdir())}
        want_wavs = {f"dataloader_{i}": [f"far_test/{p.split()[1].rsplit('/', 1)[1]}"
                                         for p in scps[name].read_text().splitlines()]
                     for i, name in enumerate(("et_simu", "et_real"))}
        n_pred = REVERB_DATA["et_simu"] + REVERB_DATA["et_real"]
        rtrain = rcfg["train_dataset"]
        log(f"[separation] reverb/spiking_fullsubnet (zoo M widths, pre-LN, 16 kHz) via "
            f"runtime.cli on {smi}: {rms:.3f} ms per update inside the trainer "
            f"({rtrain['dataloader']['batch_size']} x {rtrain['args']['duration_in_seconds']:g} "
            f"s; gaps {rgaps}), {np.mean(rval):.3f} ms per validation batch (1 x "
            f"{REVERB_SECONDS:g} s); "
            f"own peak memory {rpeak:.2f} GB; train launches {train_counts}, predict launches "
            f"{predict_counts}; losses {fmt(rprobe.losses)}; predicted wavs {wavs}")
        require(rep == [1] and len(rprobe.updates) == 2
                and all(u["launches"] == want_update for u in rprobe.updates),
                f"REVERB updates {[u['launches'] for u in rprobe.updates]}, epochs {rep}")
        require(rprobe.losses and all(np.isfinite(v) for v in rprobe.losses + rnorms),
                f"REVERB losses {rprobe.losses}, gradient norms {rnorms}")
        require(len(rprobe.evals) == REVERB_DATA["et_simu"]
                and all(e["launches"] == want_eval for e in rprobe.evals),
                f"REVERB eval batches {[e['launches'] for e in rprobe.evals]}")
        require(train_counts == dict(train_launches(2 * 8), F=4 * REVERB_DATA["et_simu"]),
                f"REVERB train launches {train_counts}")
        require(predict_counts == dict(train_launches(0), F=4 * n_pred),
                f"REVERB predict launches {predict_counts}")
        require(wavs == want_wavs, f"REVERB predicted wavs {wavs}, expected {want_wavs}")
        out["reverb"] = {"kernel_checks": rde, "ms_per_update": rms, "update_gaps_ms": rgaps,
                         "ms_per_validation_batch": float(np.mean(rval)),
                         "validation_batch_ms": rval, "own_peak_gb": rpeak,
                         "train_launches": train_counts, "predict_launches": predict_counts,
                         "losses": rprobe.losses, "grad_norms": rnorms, "predicted": wavs}
        del rt
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[separation] phase 12 took {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------------------ phase 13: remaining models

SDNN_RECIPE = ROOT / "recipes" / "intel_ndns" / "sdnn_delays"
SHARED_BOTTLENECK = 224  # the shared stack at the sub-band width the plans are tested at
# the SDNN runs' SyntheticNoisyDataset sets: (items, seconds, seed)
SDNN_DATA = {"train_dataset": (64, 4.0, 0), "validate_dataset": (16, 4.0, 77),
             "test_dataset": (2, 4.0, 99)}
SMALL_B, SMALL_SECONDS = 8, 4.0  # ALIF and FullSubNet
# FullSubNet's DNS-Interspeech-2020 train.toml [model.args] and [acoustics]
FULLSUBNET = dict(num_freqs=257, look_ahead=2, sequence_model="LSTM", fb_num_neighbors=0,
                  sb_num_neighbors=15, fb_output_activate_function="ReLU",
                  sb_output_activate_function=False, fb_model_hidden_size=512,
                  sb_model_hidden_size=384, norm_type="offline_laplace_norm",
                  num_groups_in_drop_band=2)
FULLSUBNET_STFT = (512, 256, 512)


def sdnn_config(save_dir, max_epochs):
    """sdnn_delays/baseline.toml with max_epochs changed on SDNN_DATA's
    SyntheticNoisyDataset at the recipe's batch sizes (test at 1)."""
    from spiking_fullsubnet_torch.runtime.config import toml_load
    cfg = toml_load(SDNN_RECIPE / "baseline.toml")
    cfg["meta"]["save_dir"] = str(save_dir)
    cfg["trainer"]["args"]["max_epochs"] = max_epochs
    for name, (n, secs, seed) in SDNN_DATA.items():
        cfg[name] = {"path": "spiking_fullsubnet_tpu.data.SyntheticNoisyDataset",
                     "args": {"num_samples": n, "duration": secs, "seed": seed,
                              "train": name == "train_dataset"},
                     "dataloader": dict(cfg[name]["dataloader"], num_workers=0)}
    return cfg


def f64_tree(tree):
    return tree_map(lambda t: t.detach().double(), tree)


def spikes_of(out):
    """Every spiking layer's output of a layered forward (the stack inputs
    and the projections left out)."""
    fb = out["fb_all_layer_outputs"][1:3]
    return list(fb) + [a for sec in out["sb_all_layer_outputs"] for a in sec[1:3]]


def shared_subband_checks(gk, dev, noisy, clean):
    """Phase 13 (a); returns its numbers and the kernels' rows."""
    from spiking_fullsubnet_torch.models.spiking_fullsubnet import (separator_config,
                                                                    spiking_fullsubnet_apply,
                                                                    spiking_fullsubnet_init)
    cfg = replace(separator_config(norm_type="offline_laplace_norm", shared_weights=True, bn=True),
                  sb_shared_bottleneck=SHARED_BOTTLENECK)
    params, state = spiking_fullsubnet_init(0, cfg, device=dev)
    units = sum((hi - lo) // c for lo, hi, c in zip(cfg.freq_cutoffs, cfg.freq_cutoffs[1:],
                                                    cfg.center_freq_sizes))
    forward = lambda x: spiking_fullsubnet_apply(cfg, params, state, x)  # noqa: E731
    torch.set_grad_enabled(False)
    zero_counts(gk)
    out = forward(noisy)
    torch.cuda.synchronize()
    counts = launch_counts(gk)
    require(counts == dict(train_launches(0), F=2), f"shared sub-band eval launches {counts}")
    require(bool(torch.isfinite(out["enhanced_y"]).all())
            and tuple(out["enhanced_y"].shape) == tuple(noisy.shape), "shared sub-band audio")
    del out
    f_args = capture_f_args(gk, forward, noisy)
    require([tuple(a[0].shape[1:]) for a in f_args]
            == [(TRAIN_B, cfg.fb_input_size), (TRAIN_B * units, SHARED_BOTTLENECK)],
            f"shared sub-band F launches {[tuple(a[0].shape) for a in f_args]}")
    rec = {"launches": counts, "f_shapes": [list(a[0].shape) for a in f_args],
           "head_spike_mismatch": [], "drift_f64": [], "plain_drift_f64": [], "f_ms": [],
           "f_plain_ms": [], "f_bound_ms": []}
    for args in f_args:
        head = (args[0][:WINDOW].contiguous(), *args[1:])
        rec["head_spike_mismatch"].append(spike_mismatch(gk.gsu_stack_eval_x(*head),
                                                         gk.stack_eval_x_plain(*head)))
        sub = (args[0][:, :ROWS_F64].contiguous(), *args[1:])
        got, ora = gk.gsu_stack_eval_x(*sub), gk.stack_eval_x_plain(*as_f64_f(sub))
        rec["drift_f64"].append(spike_mismatch(got, ora))
        rec["plain_drift_f64"].append(spike_mismatch(gk.stack_eval_x_plain(*sub), ora))
        plain_ms, spikes, _ = plain_run(gk.stack_eval_x_plain, args)
        nbytes, _, ops_s = bound_f(args, spikes)
        rec["f_ms"].append(cuda_ms(lambda: gk.gsu_stack_eval_x(*args), iters=3))
        rec["f_plain_ms"].append(plain_ms)
        rec["f_bound_ms"].append(max(nbytes / HBM_BYTES_PER_S * 1e3, ops_s * 1e3))
        del got, ora
    for i, stack in enumerate(("fullband", "shared stack")):
        require(rec["head_spike_mismatch"][i] < 1e-3,
                f"kernel F shared sub-band {stack} first {WINDOW} frames: {rec}")
        require(rec["drift_f64"][i] <= 3 * rec["plain_drift_f64"][i] + 1e-3,
                f"kernel F shared sub-band {stack}: drift {rec}")
    rec["forward_ms"] = cuda_ms(lambda: forward(noisy), iters=2)
    del f_args
    torch.set_grad_enabled(True)
    rec["step"] = time_train(spiking_fullsubnet_apply, cfg, params, state, noisy, clean,
                             train_launches(4), iters=1)
    require(not rec["step"]["nonfinite_steps"], f"shared sub-band train step {rec['step']}")
    d_args, e_args = capture_de_args(gk, lambda: fwd_bwd(
        spiking_fullsubnet_apply, cfg, fresh(params), state, noisy, clean))
    rec["kernel_checks"] = de_arg_checks(gk, "shared sub-band", d_args, e_args,
                                         stacks=("fullband", "shared stack"))
    rows = {"D": [], "E": [], "dW": []}
    for da, ea in zip(d_args, e_args):
        y = gk.gsu_layer_train_fwd(*da)[0]
        dxg = gk.gsu_layer_train_bwd(*ea)[0]
        n = fired(ea[1])
        for k, fn, (nbytes, _, ops_s) in (
                ("D", lambda: gk.gsu_layer_train_fwd(*da), bound_d(da, fired(y))),
                ("E", lambda: gk.gsu_layer_train_bwd(*ea), bound_e(ea, n)),
                ("dW", lambda: gk.gsu_train_dw(ea[1], dxg), bound_dw(ea[1], dxg, n))):
            rows[k].append({"shape": list(da[0].shape), "ms": cuda_ms(fn, iters=2),
                            "bound_ms": max(nbytes / HBM_BYTES_PER_S * 1e3, ops_s * 1e3)})
        del y, dxg
    rec["de_rows"] = rows
    fmt = lambda v: "[" + ", ".join(f"{x:.3f}" for x in v) + "]"  # noqa: E731
    log(f"[remaining] shared sub-band (zoo M widths, bottleneck {SHARED_BOTTLENECK}, f32) at "
        f"{TRAIN_B} x {TRAIN_SECONDS:g} s: eval forward {rec['forward_ms']:.3f} ms, launches "
        f"{counts}; F {rec['f_shapes']}: {fmt(rec['f_ms'])} ms (plain {fmt(rec['f_plain_ms'])}, "
        f"bound {fmt(rec['f_bound_ms'])}); first {WINDOW} frames spike mismatch "
        f"{rec['head_spike_mismatch']}, against float64 kernel {rec['drift_f64']} plain "
        f"{rec['plain_drift_f64']}; train step {rec['step']['total_ms']:.3f} ms (forward "
        f"{rec['step']['forward_ms']:.3f}, backward {rec['step']['backward_ms']:.3f}, clip and "
        f"AdamW {rec['step']['step_ms']:.3f}), launches {rec['step']['launches']}; "
        + "; ".join(f"{k} {[r['shape'] for r in v]} {fmt([r['ms'] for r in v])} ms (bound "
                    f"{fmt([r['bound_ms'] for r in v])})" for k, v in rows.items()))
    del params, state
    return rec


def sdnn_checks(gk, dev):
    """Phase 13 (b); returns its numbers."""
    import shutil
    import tempfile

    from spiking_fullsubnet_torch.recipes.sdnn_delays import SdnnDelaysTrainer
    from spiking_fullsubnet_torch.runtime.config import toml_dump

    save_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_sdnn_"))
    toml = save_dir / "sdnn_smoke.toml"
    try:
        toml_dump(sdnn_config(save_dir, 1), toml)
        zero_counts(gk)
        with TrainerProbe(SdnnDelaysTrainer, gk) as probe:
            (first, ep1), = probed_runs(probe, [["-M", "train"]], toml, SDNN_RECIPE, dev)
            toml_dump(sdnn_config(save_dir, 2), toml)
            (resumed, ep2), (tested, _) = probed_runs(
                probe, [["-M", "train", "-R"], ["-M", "test", "predict", "--ckpt_path", "best"]],
                toml, SDNN_RECIPE, dev)
        torch.cuda.synchronize()
        launches = launch_counts(gk)
        norms = [u["norm"] for u in probe.updates]
        n_val = SDNN_DATA["validate_dataset"][0] // 16
        ms, gaps = update_ms(probe)
        val = [e["s"] * 1e3 for e in probe.evals[:n_val]]
        wavs = sorted(p.name for p in (tested.enhanced_dir / "dataloader_0").glob("*.wav"))
        cfg = tested.model_config
        log(f"[remaining] sdnn_delays/baseline.toml ({cfg.input_size} -> {cfg.hidden_size} -> "
            f"{cfg.hidden_size} -> {cfg.input_size}, max_delay {cfg.max_delay}) via runtime.cli "
            f"on {card_name()}: {ms:.3f} ms per update inside the trainer (32 x 4 s; gaps "
            f"{gaps}), {np.mean(val):.3f} ms per validation batch (16 x 4 s); launches "
            f"{launches}; losses {probe.losses}; gradient norms {norms}; predicted {wavs}")
        require((cfg.input_size, cfg.hidden_size, cfg.max_delay, cfg.threshold)
                == (257, 512, 64, 0.1), f"sdnn baseline config {cfg}")
        require(ep1 == [1] and ep2 == [2] and resumed.state.epochs_trained == 2
                and len(probe.updates) == 4, f"sdnn epochs {ep1}, {ep2}, {len(probe.updates)}")
        require(probe.losses and all(np.isfinite(v) for v in probe.losses + norms),
                f"sdnn losses {probe.losses}, gradient norms {norms}")
        require(not any(launches.values()), f"sdnn launched kernels {launches}")
        require(len(wavs) == SDNN_DATA["test_dataset"][0], f"sdnn predicted {wavs}")
        return {"ms_per_update": ms, "update_gaps_ms": gaps,
                "ms_per_validation_batch": float(np.mean(val)), "validation_batch_ms": val,
                "launches": launches, "losses": probe.losses, "grad_norms": norms}
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)


def alif_checks(gk, dev, noisy, clean):
    """Phase 13 (c); returns its numbers."""
    from spiking_fullsubnet_torch.recipes.denoise import denoise_loss
    from spiking_fullsubnet_torch.models.spiking_fullsubnet import (separator_config,
                                                                    spiking_fullsubnet_apply,
                                                                    spiking_fullsubnet_init)
    cfg = separator_config(norm_type="offline_laplace_norm", shared_weights=True, bn=True,
                           sequence_model="ALIF")
    params, state = spiking_fullsubnet_init(0, cfg, device=dev)
    p64, x64, c64 = f64_tree(params), noisy.double(), clean.double()
    rec = {}
    zero_counts(gk)
    for mode, train in (("eval", False), ("train", True)):
        torch.set_grad_enabled(train)
        runs = []
        for p, x, c in ((params, noisy, clean), (p64, x64, c64)):
            p = fresh(p) if train else p
            out = spiking_fullsubnet_apply(cfg, p, state, x, train=train)
            norm = None
            if train:
                loss = denoise_loss(out["enhanced_y"], c)["loss"]
                loss.backward()
                norm = float(torch.sqrt(sum(t.grad.double().square().sum()
                                            for t in tensors_of(p))))
                require(np.isfinite(loss.item()) and np.isfinite(norm), f"ALIF step {loss} {norm}")
                out = tree_map(lambda t: t.detach(), out)
            runs.append((out, norm))
        (got, norm), (ref, norm64) = runs
        mism = [spike_mismatch(a, b) for a, b in zip(spikes_of(got), spikes_of(ref))]
        audio = rel_l2(got["enhanced_y"], ref["enhanced_y"])
        rec[mode] = {"spike_mismatch": mism, "audio_rel_l2": audio, "grad_norm": norm,
                     "grad_norm_f64": norm64,
                     "rate": [float(a.float().mean()) for a in spikes_of(got)]}
        log(f"[remaining] ALIF (zoo M widths) {mode} {SMALL_B} x {SMALL_SECONDS:g} s against "
            f"float64: spike mismatch per layer {[f'{v:.2e}' for v in mism]}, audio rel L2 "
            f"{audio:.3e}" + (f", gradient norm {norm:.6g} (float64 {norm64:.6g})" if train
                              else "") + f"; firing rates {[f'{v:.3f}' for v in rec[mode]['rate']]}")
        require(len(mism) == 8 and max(mism) <= 0.05 and audio < 1e-2, f"ALIF {mode}: {rec}")
        del got, ref, runs
    counts = launch_counts(gk)
    require(not any(counts.values()), f"ALIF launched kernels {counts}")
    rec["forward_ms"] = cuda_ms(lambda: spiking_fullsubnet_apply(cfg, params, state, noisy),
                                iters=1)
    torch.set_grad_enabled(False)
    return rec


def fullsubnet_checks(gk, dev, noisy, clean):
    """Phase 13 (d); returns its numbers."""
    from spiking_fullsubnet_torch.dsp.mask import build_complex_ideal_ratio_mask, drop_band
    from spiking_fullsubnet_torch.dsp.spectral import stft_complex
    from spiking_fullsubnet_torch.models.fullsubnet import build

    b = build(seed=0, device=dev, **FULLSUBNET)
    cfg, apply = b["config"], b["apply"]
    n_fft, hop, win = FULLSUBNET_STFT
    rec = {}
    mag32 = stft_complex(noisy, n_fft, hop, win).abs()[:, None]
    zero_counts(gk)
    grads, outs = [], []
    torch.set_grad_enabled(True)
    for p, x, c in ((b["params"], noisy, clean), (f64_tree(b["params"]), noisy.double(),
                                                  clean.double())):
        nspec, cspec = stft_complex(x, n_fft, hop, win), stft_complex(c, n_fft, hop, win)
        mag = nspec.abs()[:, None]
        with torch.no_grad():
            outs.append(apply(cfg, p, {}, mag, train=False)["cirm"])
        target = build_complex_ideal_ratio_mask(nspec.real, nspec.imag, cspec.real, cspec.imag)
        target = drop_band(target.permute(0, 3, 1, 2), cfg.num_groups_in_drop_band)
        p = fresh(p)
        loss = ((apply(cfg, p, {}, mag, train=True)["cirm"] - target) ** 2).mean()
        loss.backward()
        grads.append([t.grad for t in tensors_of(p)])
        rec.setdefault("loss", []).append(loss.item())
    out_rel = rel_l2(outs[0], outs[1])
    grad_rel = [rel_l2(g, r) for g, r in zip(*grads)]
    counts = launch_counts(gk)
    rec.update(cirm_rel_l2=out_rel, grad_rel_l2=grad_rel, launches=counts,
               cirm_shape=list(outs[0].shape))
    with torch.no_grad():
        rec["forward_ms"] = cuda_ms(lambda: apply(cfg, b["params"], {}, mag32, train=False),
                                    iters=1)
    log(f"[remaining] FullSubNet (published widths: fb {cfg.fb_model_hidden_size}, sb "
        f"{cfg.sb_model_hidden_size}, LSTM, 257 bins) {SMALL_B} x {SMALL_SECONDS:g} s against "
        f"float64: cIRM {rec['cirm_shape']} rel L2 {out_rel:.3e}; MSE loss {rec['loss']}; "
        f"gradient rel L2 per leaf max {max(grad_rel):.3e}; eval forward "
        f"{rec['forward_ms']:.3f} ms; launches {counts}")
    require(out_rel < 1e-4 and max(grad_rel) < 1e-4, f"FullSubNet against float64: {rec}")
    require(not any(counts.values()), f"FullSubNet launched kernels {counts}")
    return rec


def remaining_models_phase(gk, dev):
    """Phase 13 (see the module docstring); returns its numbers."""
    t_phase = time.perf_counter()
    _, _, tb_noisy, tb_clean = training_batches(dev)
    out = {"shared_subband": shared_subband_checks(gk, dev, tb_noisy, tb_clean)}
    torch.cuda.empty_cache()
    out["sdnn_delays"] = sdnn_checks(gk, dev)
    n = int(SMALL_SECONDS * SR)
    small_noisy, small_clean = tb_noisy[:SMALL_B, :n].contiguous(), tb_clean[:SMALL_B, :n].contiguous()
    out["alif"] = alif_checks(gk, dev, small_noisy, small_clean)
    out["fullsubnet"] = fullsubnet_checks(gk, dev, small_noisy, small_clean)
    del tb_noisy, tb_clean
    torch.cuda.empty_cache()
    torch.set_grad_enabled(False)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[remaining] phase 13 took {out['seconds']:.1f} s")
    return out


def add_shared_subband_rows(kernels, rec):
    """The shared sub-band's launches beside each kernel's line (F's eval
    launches; D's, E's and dW's in one step)."""
    f_rows = [{"shape": s, "ms": m, "plain_ms": p, "bound_ms": b} for s, m, p, b in zip(
        rec["f_shapes"], rec["f_ms"], rec["f_plain_ms"], rec["f_bound_ms"])]
    rows = dict(rec["de_rows"], F=f_rows)
    names = {"gsu_stack_eval_x": "F", "gsu_layer_train_fwd": "D", "gsu_layer_train_bwd": "E",
             "gsu_train_dw": "dW"}
    launches = dict(rec["step"]["launches"], F=rec["launches"]["F"])
    for entry in kernels:
        k = names.get(entry["name"])
        if k:
            entry["shared_subband"] = {"launches": launches[k],
                                       "ms": sum(r["ms"] for r in rows[k]), "per_launch": rows[k]}


# ------------------------------------------------------------------ phase 14: data-parallel training

DIST_SECONDS = 6.0  # phase 9's utterances
DIST_A_UPDATES, DIST_A_BATCH = 3, 64  # (a): updates of 64 x 6 s, the recipe's batch
DIST_B_RANKS, DIST_ROWS = 2, 8  # (b): two ranks of 8 x 6 s rows
DIST_VAL_ITEMS = 16  # phase 9's validation set
DIST_TIMEOUT = 300  # seconds the phase waits for its processes
DIST_GROUP_TIMEOUT = 120  # seconds a rank waits in a collective
DIST_REL_L2 = 1e-6  # the ranks' averaged gradients and update against one process's


def dist_config(save_dir, train_items, batch, val_items, val_batch, toml=None,
                seconds=DIST_SECONDS):
    """``toml`` (default: the flagship recipe's baseline_m.toml, M widths,
    pre-LN, scan_mode "fused": the layered formulation on the card) for one
    epoch on phase 9's SyntheticNoisyDataset: ``train_items`` x ``seconds``
    at ``batch`` a rank, ``val_items`` validated at ``val_batch`` a rank,
    each loader with the TOML's other settings (its decoding threads)."""
    from spiking_fullsubnet_torch.runtime.config import toml_load
    base = toml_load(toml or SFS_RECIPE / "baseline_m.toml")
    cfg = {k: base[k] for k in ("meta", "trainer", "optimizer", "acoustics", "model")}
    cfg["meta"]["save_dir"] = str(save_dir)
    cfg["trainer"]["args"].update(max_epochs=1, max_steps=0)
    for name, n, b in (("train_dataset", train_items, batch),
                       ("validate_dataset", val_items, val_batch)):
        cfg[name] = {"path": "spiking_fullsubnet_tpu.data.SyntheticNoisyDataset",
                     "args": {"num_samples": n, "duration": seconds,
                              "seed": TRAINER_DATA[name][2], "train": name == "train_dataset"},
                     "dataloader": dict(base[name]["dataloader"], batch_size=b,
                                        drop_last=name == "train_dataset")}
    return cfg


def dist_toml(root, name, cfg):
    """``cfg`` written as <root>/intel_ndns/spiking_fullsubnet/<name>.toml:
    the CLI reads a TOML's recipe from its directory's last two parts."""
    from spiking_fullsubnet_torch.runtime.config import toml_dump
    path = Path(root) / "intel_ndns" / "spiking_fullsubnet" / f"{name}.toml"
    path.parent.mkdir(parents=True, exist_ok=True)
    toml_dump(cfg, path)
    return path


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_process(argv, log_path, env_extra=None):
    """``argv`` from the repository's root, torchrun's variables only as
    ``env_extra`` gives them, its output to ``log_path``."""
    import os

    from spiking_fullsubnet_torch.parallel.dist import TORCHRUN_VARS
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_VARS}
    env["PYTHONPATH"] = str(ROOT) + (os.pathsep + env["PYTHONPATH"]
                                     if env.get("PYTHONPATH") else "")
    env.update(env_extra or {})
    log_file = open(log_path, "w")
    proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=log_file, stderr=subprocess.STDOUT)
    return {"proc": proc, "log": log_path, "file": log_file, "t0": time.perf_counter()}


def wait_processes(procs, timeout=DIST_TIMEOUT):
    """Wait for every process; once one fails or ``timeout`` passes, kill
    them all. Returns each one's (exit code, wall seconds, output tail)."""
    deadline = time.perf_counter() + timeout
    try:
        while any(p["proc"].poll() is None for p in procs):
            if time.perf_counter() > deadline or any(p["proc"].poll() for p in procs):
                break
            time.sleep(0.2)
            for p in procs:
                if p["proc"].poll() is not None and "s" not in p:
                    p["s"] = time.perf_counter() - p["t0"]
    finally:
        for p in procs:
            if p["proc"].poll() is None:
                p["proc"].kill()
            p["proc"].wait()
            p["file"].close()
            p.setdefault("s", time.perf_counter() - p["t0"])
    return [(p["proc"].returncode, p["s"], Path(p["log"]).read_text()[-4000:]) for p in procs]


def start_ranks(work, ranks, backend, device, cfg):
    """``cfg`` written to <work>/intel_ndns/spiking_fullsubnet/dist.toml and
    ``ranks`` processes started on it (``python3 chip_smoke.py --dist-rank
    <work> <backend> <device>``, torchrun's variables set, one port)."""
    dist_toml(work, "dist", cfg)
    port = str(free_port())
    return [start_process([sys.executable, str(ROOT / "chip_smoke.py"), "--dist-rank",
                           str(work), backend, device], Path(work) / f"rank{r}.log",
                          {"RANK": str(r), "WORLD_SIZE": str(ranks), "LOCAL_RANK": str(r),
                           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port})
            for r in range(ranks)]


def dist_rank_main(work, backend, device):
    """One rank, as ``start_ranks`` starts it: joins the group on
    ``backend`` (``device`` "cuda" is the rank's own card, cuda:LOCAL_RANK),
    runs runtime.cli.main -M train on <work>'s dist.toml, counted (counts
    set to 0 just before, read just after), with each update's and each
    validation batch's launches, each update's CUDA end event and each
    gradient average's ms; writes its weights and model state to
    <work>/rank<r>.pt, its numbers to <work>/rank<r>.json and, on rank 0,
    each update's averaged gradients, flat, to <work>/averaged.pt."""
    import os
    from datetime import timedelta

    from spiking_fullsubnet_torch.nn.core import tree_map
    from spiking_fullsubnet_torch.ops import gsu_kernels as gk
    from spiking_fullsubnet_torch.parallel import dist
    from spiking_fullsubnet_torch.recipes.denoise import DenoiseTrainer
    from spiking_fullsubnet_torch.runtime import cli
    from spiking_fullsubnet_torch.runtime import trainer as trainer_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work, rank = Path(work), int(os.environ["RANK"])
    on_card = torch.device(device).type == "cuda"
    require(dist.initialize_distributed(backend=backend, device=device,
                                        timeout=timedelta(seconds=DIST_GROUP_TIMEOUT)),
            "rank joined no group")
    if on_card:
        gk.build_kernels()  # the libraries the parent built
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    averages, averaged = [], []
    real_average = trainer_mod.average_gradients

    def timed_average(weights):
        weights = list(weights)
        sync()
        t0 = time.perf_counter()
        calls = real_average(weights)
        sync()
        averages.append({"ms": (time.perf_counter() - t0) * 1e3, "all_reduce_calls": calls})
        if rank == 0:
            averaged.append(torch.cat([w.grad.flatten() for w in weights
                                       if w.grad is not None]).cpu())
        return calls

    trainer_mod.average_gradients = timed_average
    zero_counts(gk)
    t0 = time.perf_counter()
    with TrainerProbe(DenoiseTrainer, gk) as probe:
        t = cli.main(["-C", str(work / "intel_ndns" / "spiking_fullsubnet" / "dist.toml"), "-M",
                      "train", "--device", device], recipe_dir=SFS_RECIPE)
    sync()
    secs = time.perf_counter() - t0
    launches = launch_counts(gk)
    gaps = update_ms(probe)[1] if on_card and len(probe.updates) > 1 else []
    torch.save({"params": tree_map(lambda x: x.detach().cpu(), t.params),
                "model_state": tree_map(lambda x: x.cpu(), t.model_state)},
               work / f"rank{rank}.pt")
    if rank == 0:
        torch.save(averaged, work / "averaged.pt")
    (work / f"rank{rank}.json").write_text(json.dumps({
        "rank": rank, "world": dist.process_count(), "backend": backend,
        "device": str(t.device), "launches": launches,
        "updates": [{k: u[k] for k in ("launches", "norm", "lr")} for u in probe.updates],
        "update_gaps_ms": gaps, "evals": probe.evals, "losses": probe.losses,
        "scores": probe.scores, "averages": averages, "train_and_validate_s": secs}))
    dist.shutdown()
    print(f"DIST_RANK_OK {rank}", flush=True)


def tensors_equal(a, b):
    ta, tb = tensors_of(a), tensors_of(b)
    return len(ta) == len(tb) and all(torch.equal(x, y) for x, y in zip(ta, tb))


def dist_reference(cfg, dev, ranks, rows, averaged):
    """The ranks' updates in this process: the same model from the seed;
    at each update every rank's rows (its shard of the one permutation)
    through training_step from rank 0's model state, on the kernels on the
    card, and their gradients averaged, which is held against the ranks'
    average of that update (``averaged``: rank 0's, flat); then the clip and
    AdamW's step from the ranks' average at the rate of ``ranks`` ranks
    (their sum in another order would flip the sign of AdamW's first step
    where a gradient is near 0); rank 0's model state kept. Returns (initial
    weights, weights after the updates, the model state, each update's norm,
    rate and relative L2 between the averages)."""
    from spiking_fullsubnet_torch.data.loader import shard_indices
    from spiking_fullsubnet_torch.parallel.dist import scale_lr
    from spiking_fullsubnet_torch.runtime import cli
    from spiking_fullsubnet_torch.runtime.trainer import optimizer_update

    cfg["meta"]["exp_id"] = "dist_reference"
    trainer = cli.run(cfg, False, [], recipe_dir=SFS_RECIPE, device=dev)
    loader = cli._loaders(cfg["train_dataset"], SFS_RECIPE, shuffle=True,
                          seed=cfg["meta"]["seed"])[0]
    shards = [shard_indices(loader._indices(), ranks, r, True) for r in range(ranks)]
    w0 = [w.detach().clone() for w in trainer.weights]
    trainer.base_lr = scale_lr(trainer.base_lr, world=ranks)
    trainer._build_schedules(len(averaged), len(averaged))
    state, steps = trainer.model_state, []
    for n, avg in enumerate(averaged):
        grads, states = [], []
        for shard in shards:
            batch = loader.collate_fn([loader.dataset[i] for i in shard[n * rows:(n + 1) * rows]])
            trainer.model_state = state
            trainer.optimizer.zero_grad(set_to_none=True)
            states.append(trainer.training_step(trainer.to_device(batch[0]),
                                                trainer.to_device(batch[1]))[1])
            grads.append(torch.cat([w.grad.flatten() for w in trainer.weights]))
        avg = avg.to(dev)
        err = rel_l2(avg, sum(grads) / ranks)
        offset = 0
        for w in trainer.weights:
            w.grad = avg[offset:offset + w.numel()].view_as(w).clone()
            offset += w.numel()
        lr = trainer.lr_schedule(n)
        steps.append((float(optimizer_update(trainer.optimizer, trainer.max_grad_norm, lr)), lr,
                      err))
        state = states[0]
    return w0, [w.detach().clone() for w in trainer.weights], state, steps


def check_ranks(work, ranks, ref_cfg, dev, rows, on_card, tag):
    """The ranks' results against each other and this process's
    (``dist_reference`` on ``ref_cfg``): weights and model state bit for bit
    across the ranks; each update's averaged gradients, the weights' change
    and the model state within DIST_REL_L2 of this process's; each update's
    norm within 1e-5 and its rate equal; on the card D, E and dW 8 launches
    an update and F 4 a validation batch on every rank; finite losses and a
    finite common score. Returns the numbers."""
    recs = [json.loads((Path(work) / f"rank{r}.json").read_text()) for r in range(ranks)]
    trees = [torch.load(Path(work) / f"rank{r}.pt", weights_only=True) for r in range(ranks)]
    for tree in trees[1:]:
        for part in ("params", "model_state"):
            require(tensors_equal(trees[0][part], tree[part]),
                    f"{tag}: the ranks' {part} differ")
    w0, w_ref, state_ref, steps = dist_reference(
        ref_cfg, dev, ranks, rows, torch.load(Path(work) / "averaged.pt", weights_only=True))
    got = [t.to(dev) for t in tensors_of(trees[0]["params"])]
    flat = lambda ts: torch.cat([t.flatten().double() for t in ts])  # noqa: E731
    step_err = float(torch.linalg.vector_norm(flat(got) - flat(w_ref))
                     / torch.linalg.vector_norm(flat(w_ref) - flat(w0)))
    weight_err = rel_l2(flat(got), flat(w_ref))
    state_err = rel_l2(flat([t.to(dev) for t in tensors_of(trees[0]["model_state"])]),
                       flat(tensors_of(state_ref)))
    grad_errs = [err for _, _, err in steps]
    require(max(grad_errs) < DIST_REL_L2 and step_err < DIST_REL_L2 and state_err < DIST_REL_L2,
            f"{tag}: the averaged gradients {grad_errs}, the update {step_err:.3e} and the "
            f"model state {state_err:.3e} from this process's (relative L2, limit "
            f"{DIST_REL_L2:g})")
    want_update, want_eval = train_launches(8 if on_card else 0), train_launches(0)
    want_eval["F"] = 4 if on_card else 0
    for rec in recs:
        what = f"{tag} rank {rec['rank']}"
        require([u["launches"] for u in rec["updates"]] == [want_update] * len(steps),
                f"{what} updates {rec['updates']}")
        require(rec["evals"] and all(e["launches"] == want_eval for e in rec["evals"]),
                f"{what} validation {rec['evals']}")
        require(all(np.isfinite(v) for v in rec["losses"]) and rec["losses"],
                f"{what} losses {rec['losses']}")
        for u, (norm, lr, _) in zip(rec["updates"], steps):
            require(abs(u["norm"] - norm) <= 1e-5 * norm and u["lr"] == lr,
                    f"{what} norm {u['norm']} lr {u['lr']}, reference {norm} {lr}")
    require(all(r["scores"] == recs[0]["scores"] for r in recs)
            and np.isfinite(recs[0]["scores"][0]), f"{tag} scores {[r['scores'] for r in recs]}")
    return {"grad_rel_l2": grad_errs, "step_rel_l2": step_err, "weight_rel_l2": weight_err,
            "state_rel_l2": state_err, "steps": steps, "ranks": [{k: rec[k] for k in (
                "rank", "device", "launches", "averages", "update_gaps_ms", "evals",
                "train_and_validate_s", "scores")} for rec in recs]}


def ranks_run(work, ranks, backend, device, rows, updates, ref_dev, tag, others=None,
              toml=None, seconds=DIST_SECONDS):
    """``ranks`` processes (``start_ranks``) train ``updates`` updates of
    ``rows`` x ``seconds`` rows a rank on ``toml`` (``dist_config``) and
    validate ``rows`` items a rank; ``check_ranks`` then holds them against
    this process on ``ref_dev``. ``others`` ({name: process} from
    ``start_process``) are waited for with the ranks. Fails where any of
    them fails. Returns the numbers, each process's seconds among them."""
    cfg = functools.partial(dist_config, train_items=ranks * rows * updates, batch=rows,
                            val_items=ranks * rows, val_batch=rows, toml=toml, seconds=seconds)
    procs = dict(others or {})
    procs.update((f"rank{r}", p) for r, p in enumerate(
        start_ranks(work, ranks, backend, device, cfg(Path(work) / "exp"))))
    done = dict(zip(procs, wait_processes(list(procs.values()))))
    for name, (rc, secs, tail) in done.items():
        log(f"[ranks] {tag} {name}: exit {rc} after {secs:.1f} s")
        require(rc == 0, f"{tag} {name} exited {rc}:\n{tail}")
    out = check_ranks(work, ranks, cfg(Path(work) / "exp_ref"), ref_dev, rows,
                      torch.device(ref_dev).type == "cuda", tag)
    out["process_s"] = {name: secs for name, (_, secs, _) in done.items()}
    return out


def distributed_phase(gk, dev):
    """Phase 14 (see the module docstring); returns its numbers."""
    import shutil
    import tempfile

    torch.set_grad_enabled(True)
    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_"))
    out = {}
    try:
        # (a) world size 1 on NCCL and the same run without a group, and (b)
        # two gloo ranks on cuda:0, all together; (b) checked once all end
        runs = {}
        for name, env in (("a_nccl", {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                                      "MASTER_ADDR": "127.0.0.1",
                                      "MASTER_PORT": str(free_port())}),
                          ("a_plain", None)):
            toml = dist_toml(work / name, "dist_a", dist_config(
                work / name / "exp", DIST_A_UPDATES * DIST_A_BATCH, DIST_A_BATCH,
                DIST_VAL_ITEMS, VAL_B))
            runs[name] = start_process([sys.executable, "-m", "spiking_fullsubnet_torch.runtime.cli",
                                        "-C", str(toml), "-M", "train"],
                                       work / f"{name}.log", env)
        # (b): both ranks alike, and this process's average of their gradients
        out["b"] = ranks_run(work / "b", DIST_B_RANKS, "gloo", "cuda:0", DIST_ROWS, 1, dev,
                             "phase 14", others=runs)
        out["process_s"] = out["b"]["process_s"]

        # (a): the NCCL run's checkpoint equals the run without a group
        ckpt = {name: work / name / "exp" / "dist_a" / "checkpoints" for name in runs}
        arrays = {name: torch.load(c / "epoch_0001" / "arrays.pt", map_location="cpu",
                                   weights_only=True) for name, c in ckpt.items()}
        states = {name: json.loads((c / "best" / "trainer_state.json").read_text())
                  for name, c in ckpt.items()}
        a, b = arrays["a_nccl"], arrays["a_plain"]
        for part in ("params", "model_state"):
            require(tensors_equal(a[part], b[part]),
                    f"phase 14 (a): NCCL at world size 1 and no group differ in {part}")
        opt_a, opt_b = a["opt_state"]["state"], b["opt_state"]["state"]
        require(opt_a.keys() == opt_b.keys() and all(tensors_equal(opt_a[k], opt_b[k])
                                                     for k in opt_a),
                "phase 14 (a): the optimizer states differ")
        require(states["a_nccl"] == states["a_plain"], f"phase 14 (a): trainer states {states}")
        steps = states["a_nccl"]["steps_trained"]
        require(steps == DIST_A_UPDATES, f"phase 14 (a): {steps} updates")
        out["a"] = {"updates": steps, "best_score": states["a_nccl"]["best_score"],
                    "bitwise_equal": True}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.set_grad_enabled(False)
    out["seconds"] = time.perf_counter() - t_phase
    b = out["b"]
    log(f"[distributed] phase 14 on {card_name()}: (a) NCCL at world size 1 and no group "
        f"bitwise equal after {out['a']['updates']} updates of {DIST_A_BATCH} x "
        f"{DIST_SECONDS:g} s (best {out['a']['best_score']!r}); (b) 2 gloo ranks on cuda:0 "
        f"of {DIST_ROWS} x {DIST_SECONDS:g} s: bitwise equal, averaged gradients "
        f"{b['grad_rel_l2']}, update {b['step_rel_l2']:.3e}, weights {b['weight_rel_l2']:.3e}, "
        f"model state {b['state_rel_l2']:.3e} from this process's; launches {[r['launches'] for r in b['ranks']]}; gradient "
        f"average {[a['ms'] for r in b['ranks'] for a in r['averages']]} ms; processes "
        f"{out['process_s']} s; phase {out['seconds']:.1f} s")
    return out


def add_distributed_rows(kernels, rec):
    """Each rank's launches in phase 14 (b) beside D's, E's, dW's and F's
    lines."""
    names = {"gsu_stack_eval_x": "F", "gsu_layer_train_fwd": "D", "gsu_layer_train_bwd": "E",
             "gsu_train_dw": "dW"}
    for entry in kernels:
        k = names.get(entry["name"])
        if k:
            entry["distributed"] = {"launches_per_rank": [r["launches"][k]
                                                          for r in rec["b"]["ranks"]]}


# ------------------------------------------------------------------ phase 15: the rest of the surface

SURF_B, SURF_SECONDS = 16, 6.0  # the tracer's forward and train step (zoo M, layered, f32)
SURF_CPU_SECONDS = 0.25  # the CPU route's forward whose frame names the card's must equal
# F's traced instance against F's plain version over the first WINDOW frames
# (as F's own checks: over the whole sequence a rounding flip of a spike
# moves every membrane after it, 1.5 % of the spikes at 751 frames), and
# over the whole sequence against the plain cell given the kernel's spikes.
# Zoo M's membranes cross 0 all the time, so their min |c| is a rounding
# residue (about 1e-7 over 1e7 membranes): TRACE_MIN_ABS and FORCED_MIN_ABS
# bound only that residue. The limits stand 3-30 times above the readings
# on an H100 (window 3.2e-7 max, 6.0e-7 min; whole sequence 5.1e-6 max,
# 5.0e-8 min, 2.8e-6 of the spikes not reproduced; the same in every run).
TRACE_MAX_REL, TRACE_MIN_ABS = 1e-5, 1e-5
FORCED_MAX_REL, FORCED_MIN_ABS, FORCED_FLIPS = 5e-5, 1e-6, 2e-5
# the same launches with BN scale SHIFTED_SCALE and shifts of +-(1 + u / H)
# a unit u (``shifted_coef``): every membrane stays at least SHIFTED_FLOOR
# from 0, no spike flips, and min |c| and max |c| over the whole sequence
# are held relatively, min |c| far above rounding
SHIFTED_SCALE, SHIFTED_FLOOR, SHIFTED_REL = 0.02, 0.5, 1e-5
MODULE_REL_L2 = 1e-4  # models/modules.py in CUDA f32 against CPU f64 (tests/test_torch_cuda_separation.py's)
# the recurrences' steps in (d): the randomly initialised LayerNormLSTM is
# chaotic, its float32 rounding growing about tenfold every 50 steps on the
# CPU as on the card (CPU float32 against float64 at 257 -> 256 x 2: 6.0e-6
# at 50 steps, 4.9e-5 at 100, 4.5e-3 at 200); the other recurrences stay
# near 2e-7
RNN_STEPS = 64
WAV_FILES, WAV_SECONDS, CROP_SECONDS = 64, 30.0, 6.0  # the native reader's batch


def module_cases(rng):
    """(name, function, f64 CPU arguments) of every ``models/modules.py``
    function at the widths of the reference's usual configurations: the TCN
    at Conv-TasNet's (N 512, B 128, H 512, P 3, X 8, R 3), TAC and the RNNs
    at 128-256 units, the conformer convolution at 256 channels, MVDR over 6
    channels x 257 bins; the recurrences over RNN_STEPS steps. Weights from
    the port's inits (seed 0), inputs from ``rng``."""
    from spiking_fullsubnet_torch.models import modules as M

    gen = torch.Generator().manual_seed(0)

    def w(tree):
        return tree_map(lambda t: t.double(), tree)

    def x(*shape, positive=False):
        a = rng.standard_normal(shape)
        return torch.from_numpy(np.abs(a) if positive else a)

    def cx(*shape):
        return torch.complex(x(*shape), x(*shape))

    tcn = w(M.tcn_estimator_init(gen, 512, 1024, 128, 512, layer=8, stack=3, kernel=3))
    spec = cx(2, 6, 257, 751)
    mask = torch.from_numpy(rng.uniform(0, 1, (2, 257, 751)))
    a, b = cx(2, 257, 6, 6), cx(2, 257, 6, 6)
    phi_s, phi_n = a @ a.conj().transpose(-1, -2), b @ b.conj().transpose(-1, -2)
    return [
        ("cumulative_layer_norm_affine", M.cumulative_layer_norm_affine,
         (x(4, 512, 1000), 1 + 0.1 * x(512), 0.1 * x(512)), {}),
        ("cumulative_mag_spectral_norm", M.cumulative_mag_spectral_norm,
         (x(4, 1, 257, 751, positive=True),), dict(cumulative=True)),
        ("cumulative_norm", M.cumulative_norm, (x(4, 1, 257, 751, positive=True),), {}),
        ("depth_conv1d_apply", M.depth_conv1d_apply,
         (w(M.depth_conv1d_init(gen, 128, 512, 3, causal=True)), x(2, 128, 1000)),
         dict(kernel=3, dilation=4, causal=True)),
        ("tcn_estimator_apply", M.tcn_estimator_apply, (tcn, x(1, 512, 1000)),
         dict(layer=8, stack=3, kernel=3, causal=True)),
        ("tac_apply", M.tac_apply, (w(M.tac_init(gen, 128, 256)), x(2, 4, 128, 200)), {}),
        ("residual_lstm_apply", M.residual_lstm_apply,
         (w(M.residual_lstm_init(gen, 257, 257, 256)), x(2, 257, RNN_STEPS)),
         dict(hidden_size=256)),
        ("grouped_linear_apply", M.grouped_linear_apply,
         (w(M.grouped_linear_init(gen, 256, 256, groups=4)), x(2, 200, 256)), dict(groups=4)),
        ("shared_group_gru_apply", M.shared_group_gru_apply,
         (w(M.shared_group_gru_init(gen, 256, 256, num_layers=2, num_groups=4)), x(RNN_STEPS, 2, 256)),
         dict(hidden_size=256, num_groups=4)),
        ("layer_norm_lstm_apply", M.layer_norm_lstm_apply,
         (w(M.layer_norm_lstm_init(gen, 257, 256, num_layers=2)), x(RNN_STEPS, 2, 257)),
         dict(hidden_size=256)),
        ("mogrifier_lstm_apply", M.mogrifier_lstm_apply,
         (w(M.mogrifier_lstm_init(gen, 257, 256, mogrify_steps=5)), x(RNN_STEPS, 2, 257)),
         dict(hidden_size=256, mogrify_steps=5)),
        ("causal_conformer_conv_apply", M.causal_conformer_conv_apply,
         (w(M.causal_conformer_conv_init(gen, 256, kernel_size=15)), x(2, 256, 751)),
         dict(kernel_size=15)),
        ("complex_outer", M.complex_outer, (spec[:1, :, :, :200],), {}),
        ("spatial_covariance", M.spatial_covariance, (spec, mask), {}),
        ("mvdr_weights", M.mvdr_weights, (phi_s, phi_n), {}),
        ("apply_beamforming", M.apply_beamforming, (spec, cx(2, 257, 6)), {}),
    ]


def forced_trace(gk, args, spikes):
    """The trace ``[L, 4]`` of the membranes that F's plain cell gives when
    every layer's inputs and recurrent spikes are the kernel's ``spikes``
    (so that no flip cascades), and the share of the kernel's spikes that
    these membranes do not reproduce. ``args`` as ``gsu_stack_eval_x``'s."""
    x, wih0, wihr, whh, coef, hidden, shared = args
    T, R, _ = x.shape
    L = whh.shape[0]
    ext = gk.trace_init(L, x.device)
    flips = 0.0
    for k in range(L):
        s = spikes.float()
        inp = x.float() @ wih0.float() if k == 0 else s[k - 1] @ wihr[k - 1].float()
        prev = torch.cat([torch.zeros_like(s[k, :1]), s[k, :-1]])
        pre = inp + prev @ whh[k].float()
        b_f, b_c, scale, shift = coef[k]
        if shared:
            f, g = torch.sigmoid(pre + b_f), pre + b_c
        else:
            f, g = torch.sigmoid(pre[..., :hidden] + b_f), pre[..., hidden:] + b_c
        c = torch.zeros_like(f[0])
        mem = torch.empty_like(f)
        for t in range(T):
            c = (f[t] * c + (1.0 - f[t]) * g[t]) * scale + shift
            mem[t] = c
        gk.trace_fold(ext[k:k + 1], mem[None])
        flips = max(flips, spike_mismatch((mem >= 0).float(), s[k]))
    return ext.cpu(), flips


def shifted_coef(coef, scale=SHIFTED_SCALE):
    """``coef [L, 4, H]`` with BN scale ``scale`` and shift +-(1 + u / H)
    (sign alternating over the units u): |c - shift| <= scale max(|c|, |g|),
    so the membranes keep away from 0 while |g| < (1 - SHIFTED_FLOOR) /
    scale - 2."""
    H = coef.shape[-1]
    u = torch.arange(H, dtype=coef.dtype, device=coef.device)
    out = coef.clone()
    out[:, 2] = scale
    out[:, 3] = (1 - 2 * (u % 2)) * (1 + u / H)
    return out


def modules_on_card(dev):
    """Phase 15 (d): each function in CUDA float32 (TF32 off) against its CPU
    float64 result."""
    rows = {}
    for name, fn, args, kw in module_cases(np.random.default_rng(15)):
        ref = fn(*args, **kw)
        t0 = time.perf_counter()
        got = fn(*tree_map(lambda t: t.to(dev, torch.complex64 if t.is_complex()
                                          else torch.float32), args), **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        pairs = list(zip(got, ref)) if isinstance(ref, tuple) else [(got, ref)]
        rel = max(rel_l2(torch.view_as_real(g.cpu()) if g.is_complex() else g.cpu(),
                         torch.view_as_real(r) if r.is_complex() else r) for g, r in pairs)
        rows[name] = {"rel_l2": rel, "shape": list(pairs[0][1].shape), "ms": ms}
        require(rel < MODULE_REL_L2, f"phase 15 (d): {name} relative L2 {rel} on the card")
    return rows


def reader_checks(work):
    """Phase 15 (e): the native reader on WAV_FILES int16 WAVs of
    WAV_SECONDS, against scipy, and the DNS dataset's native path."""
    from scipy.io import wavfile

    from spiking_fullsubnet_torch.data.dns_audio import DNSAudio
    from spiking_fullsubnet_torch.native import wavio

    require(wavio.native_available(), "phase 15 (e): the native reader did not build")
    rng = np.random.default_rng(15)
    n, crop = int(WAV_SECONDS * SR), int(CROP_SECONDS * SR)
    for d in ("noisy", "clean"):
        (work / d).mkdir()
    paths = []
    for i in range(WAV_FILES):
        kind = "noisy" if i % 2 == 0 else "clean"
        name = (f"book_snr5_tl-25_fileid_{i // 2}.wav" if kind == "noisy"
                else f"clean_fileid_{i // 2}.wav")
        paths.append(work / kind / name)
        wavfile.write(str(paths[-1]), SR, (rng.standard_normal(n) * 3000).astype(np.int16))
    mb = sum(p.stat().st_size for p in paths) / 1e6
    offsets = rng.integers(0, n - crop, WAV_FILES)
    t0 = time.perf_counter()
    got = wavio.read_batch(paths, offsets, crop)
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref = np.stack([(wavfile.read(str(p))[1] / 32768.0).astype(np.float32)[o:o + crop]
                    for p, o in zip(paths, offsets)])
    scipy_ms = (time.perf_counter() - t0) * 1e3
    require(np.array_equal(got, ref), "phase 15 (e): read_batch differs from scipy's read")
    fast = DNSAudio(root=str(work), train=True, sublen=int(CROP_SECONDS))
    slow = DNSAudio(root=str(work), train=True, sublen=int(CROP_SECONDS))
    slow.use_native = False
    require(fast.use_native, "phase 15 (e): the DNS dataset did not take the native path")
    items, items_ms = {}, {}
    for tag, ds in (("native", fast), ("scipy", slow)):
        np.random.seed(15)  # the same crops: one draw an item
        t0 = time.perf_counter()
        items[tag] = [ds[k] for k in range(len(ds))]
        items_ms[tag] = (time.perf_counter() - t0) * 1e3
    require(all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                for a, b in zip(items["native"], items["scipy"])),
            "phase 15 (e): the DNS dataset's native path differs from its scipy path")
    return {"files": WAV_FILES, "megabytes": mb, "crop_s": CROP_SECONDS,
            "read_batch_ms": native_ms, "scipy_ms": scipy_ms, "bitwise_equal": True,
            "dns_items": len(fast), "dns_native_ms": items_ms["native"],
            "dns_scipy_ms": items_ms["scipy"], "dns_native": True}


def surface_phase(gk, dev):
    """Phase 15 (see the module docstring); returns its numbers."""
    import shutil
    import tempfile

    from spiking_fullsubnet_torch.models.spiking_fullsubnet import (
        SpikingFullSubNet, separator_config, spiking_fullsubnet_apply)
    from spiking_fullsubnet_torch.nn import module_tracer as mt
    from spiking_fullsubnet_torch.nn.module_tracer import extremes_frame

    t_phase = time.perf_counter()
    card = card_name()
    out = {}
    cfg = separator_config(norm_type="offline_laplace_norm", shared_weights=True, bn=True)
    model = SpikingFullSubNet.from_npz(str(ZOO_M), cfg, device=dev)
    p, st = model.param_tree(), model.state_tree()
    _, _, tb_noisy, tb_clean = training_batches(dev)
    x = tb_noisy[:SURF_B, :int(SURF_SECONDS * SR)].contiguous()
    clean = tb_clean[:SURF_B, :int(SURF_SECONDS * SR)].contiguous()

    def forward(params=p):
        return spiking_fullsubnet_apply(cfg, params, st, x)

    def counted(fn):
        zero_counts(gk)
        res = fn()
        torch.cuda.synchronize()
        return res, launch_counts(gk)

    def equal_out(a, b):
        return (torch.equal(a["enhanced_y"], b["enhanced_y"])
                and all(torch.equal(u, v) for u, v in zip(a["fb_all_layer_outputs"],
                                                          b["fb_all_layer_outputs"]))
                and all(torch.equal(u, v) for su, sv in zip(a["sb_all_layer_outputs"],
                                                            b["sb_all_layer_outputs"])
                        for u, v in zip(su, sv)))

    # ---- (a) the tracer in eval ----
    torch.set_grad_enabled(False)
    before, plain_counts = counted(forward)
    seen = {}

    def traced_forward():
        with mt.ActivationTracer() as tr:
            seen["out"] = forward()
        return tr

    tr, counts = counted(traced_forward)
    f_args = [a for a, _ in record_calls(gk, ["gsu_stack_eval_x"], traced_forward)
              ["gsu_stack_eval_x"]]
    after, _ = counted(forward)
    require(counts["F"] == 4 and counts == plain_counts,
            f"phase 15 (a): launches {counts} under the tracer, {plain_counts} without")
    require(equal_out(before, after) and equal_out(before, seen["out"]),
            "phase 15 (a): the forward's output moved with the tracer")
    cpu = torch.device("cpu")
    cpu_model = SpikingFullSubNet.from_npz(str(ZOO_M), cfg, device=cpu)
    with mt.ActivationTracer() as cpu_tr:
        cpu_model(x[:1, :int(SURF_CPU_SECONDS * SR)].cpu())
    names = [f[0] for f in tr.frames]
    require(names == [f[0] for f in cpu_tr.frames],
            f"phase 15 (a): frame names {names} differ from the CPU route's")
    mem = [f for f in tr.frames if f[0].endswith("/membrane")]
    require(len(mem) == 8 and len(f_args) == 4, f"phase 15 (a): {len(mem)} membrane frames")
    worst = {k: 0.0 for k in ("max_rel", "min_abs", "forced_max_rel", "forced_min_abs",
                              "forced_flips", "whole_spike_mismatch", "shifted_min_rel",
                              "shifted_max_rel")}
    shifted_floor = math.inf
    for k, a in enumerate(f_args):
        # the first WINDOW frames: the traced instance against F's plain version
        xw = (a[0][:WINDOW].contiguous(),) + tuple(a[1:])
        _, ext_w = gk.gsu_stack_eval_x(*xw, trace=True)
        ext_p = []
        gk.stack_eval_x_plain(*xw, extremes=ext_p)
        for e, r in zip(ext_w, ext_p[0]):
            worst["max_rel"] = max(worst["max_rel"], abs(e[1] - r[1]).item() / r[1].item())
            worst["min_abs"] = max(worst["min_abs"], abs(e[0] - r[0]).item())
            require(e[2] == r[2] == 0, f"phase 15 (a): non-finite membranes {e}, plain {r}")
        # the whole sequence: the forward's frames are this launch's trace
        # (the kernel is bitwise deterministic), held against the plain cell
        # given the kernel's spikes
        spikes_k, ext = gk.gsu_stack_eval_x(*a, trace=True)
        forced, flips = forced_trace(gk, a, spikes_k)
        worst["forced_flips"] = max(worst["forced_flips"], flips)
        worst["whole_spike_mismatch"] = max(worst["whole_spike_mismatch"], spike_mismatch(
            spikes_k, gk.stack_eval_x_plain(*a)))
        for layer, (e, r) in enumerate(zip(ext, forced)):
            name, mn, mx, ok = mem[2 * k + layer]
            require((mn, mx, ok) == extremes_frame(e), f"phase 15 (a): {name} {(mn, mx, ok)} "
                    f"is not its launch's trace {extremes_frame(e)}")
            worst["forced_max_rel"] = max(worst["forced_max_rel"],
                                          abs(e[1] - r[1]).item() / r[1].item())
            worst["forced_min_abs"] = max(worst["forced_min_abs"], abs(e[0] - r[0]).item())
            require(ok and e[2] == r[2] == 0, f"phase 15 (a): {name} finite {ok}, {e}, {r}")
        # the whole sequence with the membranes shifted away from 0
        sa = a[:4] + (shifted_coef(a[4]),) + a[5:]
        spikes_s, ext_s = gk.gsu_stack_eval_x(*sa, trace=True)
        ref_s = []
        plain_s = gk.stack_eval_x_plain(*sa, extremes=ref_s)
        ref_s = ref_s[0]
        shifted_floor = min(shifted_floor, ref_s[:, 0].min().item())
        require(torch.equal(spikes_s, plain_s) and (ext_s[:, 2:] == 0).all()
                and (ref_s[:, 2:] == 0).all(),
                f"phase 15 (a): shifted membranes of stack {k}: spikes or counts differ, "
                f"{ext_s} against {ref_s}")
        rel = ((ext_s[:, :2] - ref_s[:, :2]).abs() / ref_s[:, :2]).amax(0)
        worst["shifted_min_rel"] = max(worst["shifted_min_rel"], rel[0].item())
        worst["shifted_max_rel"] = max(worst["shifted_max_rel"], rel[1].item())
    require(worst["max_rel"] <= TRACE_MAX_REL and worst["min_abs"] <= TRACE_MIN_ABS
            and worst["forced_max_rel"] <= FORCED_MAX_REL
            and worst["forced_min_abs"] <= FORCED_MIN_ABS
            and worst["forced_flips"] <= FORCED_FLIPS
            and shifted_floor >= SHIFTED_FLOOR
            and worst["shifted_min_rel"] <= SHIFTED_REL and worst["shifted_max_rel"] <= SHIFTED_REL,
            f"phase 15 (a): membrane frames against F's plain version {worst}, shifted "
            f"membranes' least |c| {shifted_floor}")
    fwd_ms = cuda_ms(forward, iters=2)
    traced_ms = cuda_ms(traced_forward, iters=2)
    f_ms = sum(cuda_ms(lambda: gk.gsu_stack_eval_x(*a), iters=3) for a in f_args)
    f_traced_ms = sum(cuda_ms(lambda: gk.gsu_stack_eval_x(*a, trace=True), iters=3)
                      for a in f_args)
    out["eval"] = {"launches": counts, "frames": len(names), "membrane_frames": len(mem),
                   "vs_plain": worst, "shifted_min_abs_c": shifted_floor, "forward_ms": fwd_ms, "traced_forward_ms": traced_ms,
                   "f_ms": f_ms, "f_traced_ms": f_traced_ms, "bitwise_untraced": True}
    log(f"[surface] (a) tracer in eval, zoo M layered f32 {SURF_B} x {SURF_SECONDS:g} s on "
        f"{card}: F {counts['F']} launches traced as untraced; {len(names)} frames, names equal "
        f"the CPU route's; membrane frames against F's plain version over the first {WINDOW} "
        f"frames: max |c| within {worst['max_rel']:.3e} relative, min |c| within "
        f"{worst['min_abs']:.3e}; over the whole sequence against the plain cell given the "
        f"kernel's spikes: {worst['forced_max_rel']:.3e}, {worst['forced_min_abs']:.3e}, spikes "
        f"not reproduced {worst['forced_flips']:.2e} (kernel against plain version "
        f"{worst['whole_spike_mismatch']:.2e}); shifted membranes (BN scale {SHIFTED_SCALE:g}, "
        f"least |c| {shifted_floor:.4f}) over the whole sequence: min |c| within "
        f"{worst['shifted_min_rel']:.3e} relative, max |c| within "
        f"{worst['shifted_max_rel']:.3e}, spikes equal; output bitwise equal with the tracer open and "
        f"closed; "
        f"forward {fwd_ms:.3f} ms untraced, {traced_ms:.3f} ms traced; F's four launches "
        f"{f_ms:.3f} ms untraced, {f_traced_ms:.3f} ms traced (with the host reduction)")

    # ---- (b) the abort ----
    poisoned = tree_map(lambda t: t, p)
    whh = p["fb"]["stack"]["layers"][1]["weight_hh"].detach().clone()
    whh[0, 0] = float("inf")
    poisoned["fb"]["stack"]["layers"][1]["weight_hh"] = whh
    zero_counts(gk)
    try:
        with mt.ActivationTracer():
            forward(poisoned)
        msg = None
    except mt.FloatingPointAbort as e:
        msg = str(e)
    torch.cuda.synchronize()
    f_launched = gk.gsu_stack_eval_x.launches
    require(msg is not None and "fb/gsu_layer1/membrane" in msg.splitlines()[0]
            and "module trail" in msg and f_launched >= 1,
            f"phase 15 (b): the poisoned forward gave {msg!r}, F launches {f_launched}")
    out["abort"] = {"first_line": msg.splitlines()[0], "f_launches": f_launched,
                    "trail": msg.split("most recent last):\n")[1].splitlines()}
    log(f"[surface] (b) abort: {out['abort']['first_line']} (F {f_launched} launch); trail "
        f"{[line.split()[-3] if '!!' in line else line.split()[0] for line in out['abort']['trail']]}")

    # ---- (c) the tracer in training ----
    torch.set_grad_enabled(True)

    def step(traced):
        q = fresh(p)
        ys = []

        def run():
            if not traced:
                return fwd_bwd(spiking_fullsubnet_apply, cfg, q, st, x, clean)
            with mt.ActivationTracer() as ttr:
                res = fwd_bwd(spiking_fullsubnet_apply, cfg, q, st, x, clean)
            ys.append(ttr.frames)
            return res

        (loss, _), counts = counted(run)
        return loss, [t.grad for t in tensors_of(q)], counts, (ys[0] if ys else None)

    loss0, grads0, counts0, _ = step(False)
    d_args = [a for a, _ in record_calls(gk, ["gsu_layer_train_fwd"], lambda: step(True))
              ["gsu_layer_train_fwd"]]
    loss1, grads1, counts1, frames = step(True)
    same = torch.equal(loss0, loss1) and all(torch.equal(a, b) for a, b in zip(grads0, grads1))
    require(same, "phase 15 (c): the train step moved with the tracer open")
    require(counts0 == counts1 and counts1["D"] == 8 and counts1["E"] == 8,
            f"phase 15 (c): launches {counts1} traced, {counts0} untraced")
    tmem = [f for f in frames if f[0].endswith("/membrane")]
    ys = [gk.gsu_layer_train_fwd(*a)[1] for a in d_args]
    require(len(tmem) == len(ys) == 8 and all(f[1:] == mt.abs_extremes(y)
                                               for f, y in zip(tmem, ys)),
            "phase 15 (c): the membrane frames are not kernel D's y")
    torch.set_grad_enabled(False)
    out["train"] = {"launches": counts1, "loss": loss1.item(), "bitwise_equal": True,
                    "membrane_frames": len(tmem)}
    log(f"[surface] (c) tracer in training, zoo M layered f32 {SURF_B} x {SURF_SECONDS:g} s on "
        f"{card}: launches {counts1} traced and untraced, loss {loss1.item():.6f} and every "
        f"gradient bitwise equal; {len(tmem)} membrane frames equal kernel D's y")
    del grads0, grads1, ys, d_args
    torch.cuda.empty_cache()

    # ---- (d) models/modules.py on the card ----
    out["modules"] = modules_on_card(dev)
    log(f"[surface] (d) models/modules.py in CUDA f32 against CPU f64 on {card}: "
        + ", ".join(f"{k} {v['rel_l2']:.2e}" for k, v in out["modules"].items()))

    # ---- (e) the native reader ----
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_wav_"))
    try:
        out["reader"] = reader_checks(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    r = out["reader"]
    log(f"[surface] (e) native reader on {card}'s host: read_batch of {r['files']} x "
        f"{r['crop_s']:g} s crops from {r['megabytes']:.1f} MB of 30 s int16 WAVs "
        f"{r['read_batch_ms']:.2f} ms, scipy read and crop {r['scipy_ms']:.2f} ms, bitwise equal; "
        f"the DNS dataset's {r['dns_items']} items native {r['dns_native_ms']:.2f} ms, scipy "
        f"{r['dns_scipy_ms']:.2f} ms, equal")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[surface] phase 15 took {out['seconds']:.1f} s")
    return out


def add_surface_rows(kernels, rec):
    """Kernel F's traced instance beside F's line (phase 15 (a))."""
    for entry in kernels:
        if entry["name"] == "gsu_stack_eval_x":
            e = rec["eval"]
            entry["traced"] = {"launches": e["launches"]["F"], "ms": e["f_traced_ms"],
                               "untraced_ms": e["f_ms"], "shape": f"zoo M {SURF_B} x "
                                                                  f"{SURF_SECONDS:g} s f32"}


# ------------------------------------------------------------------ phase 16: band-parallel sub-bands

BAND_B, BAND_SECONDS = 8, 2.0  # a data rank's utterances (flagship M at full width)
BAND_LR, BAND_CLIP = 1e-3, 10.0  # __graft_entry__.py:66-76's step
BAND_TIMEOUT = 300  # seconds the phase waits for its ranks
BAND_WRAPPERS = {"D band": "gsu_layer_train_fwd_band", "E band": "gsu_layer_train_bwd_band"}
# frames of each band launch held against its plain version: a gloo
# all-reduce takes ≈ 2 ms between two processes of one host, two a step in D
# and one in E, kernel and plain version alike (phase 16's 60-s budget)
BAND_CHECK_FRAMES = 96
BAND_META = {"D band": ("gsu_layer_train_fwd_band", 226), "E band": ("gsu_layer_train_bwd_band", 358)}
# the band split against one process's unsharded step (the same weights and
# rows; the D and E band kernels against kernels D and E). While their
# training spikes agree, the step agrees to rounding: the loss, the BN state
# and a data group's summed gradients (observed 0, 6e-8 and 2.5e-7 on H100s).
# The BN sums are taken in another order, though, so a membrane at the
# threshold can flip, and its batch statistics carry the flip to every row of
# its layer and on (phase 6): then the step is one draw of that chaos (seen
# on four H100s: loss 5.9e-4, state 1.6e-2, gradients 7.5e-2 relative), held
# only loosely, as phase 6 logs D's drift after a flip. AdamW's first step is
# ±lr wherever a gradient's sign flips, so the update is held against this
# process's clip and AdamW on the ranks' own reduced gradients.
BAND_LOSS_REL, BAND_STATE_REL, BAND_GRAD_REL = 1e-5, 1e-5, 1e-4
BAND_FLIP_LOSS_REL, BAND_FLIP_SPIKES = 1e-2, 0.25
BAND_OWN_REL = 1e-5


def band_counts(gk):
    return dict(launch_counts(gk), **{k: getattr(gk, n).launches for k, n in BAND_WRAPPERS.items()})


def band_zero(gk):
    zero_counts(gk)
    for n in BAND_WRAPPERS.values():
        getattr(gk, n).launches = 0


def band_batch(rows, dev, seed=16):
    """``rows`` utterances of BAND_SECONDS, (noisy, clean), float32, from a
    seed: a harmonic tone in white noise."""
    rng = np.random.default_rng(seed)
    n = int(BAND_SECONDS * SR)
    t = np.arange(n) / SR
    f0 = rng.uniform(120, 300, (rows, 1))
    clean = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6)) * 0.1
    noisy = clean + rng.standard_normal((rows, n)) * 0.05
    return (torch.from_numpy(noisy.astype(np.float32)).to(dev),
            torch.from_numpy(clean.astype(np.float32)).to(dev))


def band_model(dev):
    """Flagship M (``models/presets.flagship_m``, random weights from seed 0)
    on the fused route with the data and band axes named."""
    from spiking_fullsubnet_torch.models.presets import flagship_m
    b = flagship_m(seed=0, device=dev, scan_mode="fused", data_axis="data", band_axis="band")
    return b["config"], b["params"], b["state"]


def band_step(cfg, params, state, noisy, clean, mesh=None):
    """The step of ``__graft_entry__.dryrun_multichip`` (``:66-76``): value and
    gradient of the denoise loss, clipped at 10, AdamW at 1e-3, from a fresh
    copy of ``params``; under ``mesh`` the gradients go through
    ``parallel.reduce_gradients``. Returns {"loss", "norm", "weights" (after
    the update), "state" (the new BN statistics), "grads" (before the clip,
    flat), "own" (under ``mesh``: the rank's own gradients before the
    reduction, flat), "spikes" (every GSU layer's spikes of the training
    forward, as bools)}."""
    import contextlib

    from spiking_fullsubnet_torch.models.spiking_fullsubnet import spiking_fullsubnet_apply
    from spiking_fullsubnet_torch.parallel.mesh import reduce_gradients
    from spiking_fullsubnet_torch.recipes.denoise import adamw, denoise_loss
    from spiking_fullsubnet_torch.runtime.trainer import optimizer_update

    p = fresh(params)
    leaves = tensors_of(p)
    opt = adamw(leaves, BAND_LR)
    flat = lambda: torch.cat([t.grad.flatten() for t in leaves]).detach().clone()  # noqa: E731
    own = None
    with mesh if mesh is not None else contextlib.nullcontext():
        out = spiking_fullsubnet_apply(cfg, p, state, noisy, train=True)
        loss = denoise_loss(out["enhanced_y"], clean)["loss"]
        loss.backward()
        if mesh is not None:
            own = flat()
            reduce_gradients(leaves, mesh)
    grads = flat()
    norm = optimizer_update(opt, BAND_CLIP)
    torch.cuda.synchronize()
    return {"loss": loss.item(), "norm": float(norm), "weights": [t.detach() for t in leaves],
            "state": [t.detach() for t in tensors_of(out["state"])], "grads": grads,
            "own": own, "spikes": [t.detach() >= 0.5 for t in layer_spikes(out)]}


def layer_spikes(out):
    """Every GSU layer's spikes of a forward's output dict."""
    return ([out["fb_all_layer_outputs"][k] for k in (1, 2)]
            + [sec[k] for sec in out["sb_all_layer_outputs"] for k in (1, 2)])


def band_eval(cfg, params, state, x, mesh=None):
    import contextlib

    from spiking_fullsubnet_torch.models.spiking_fullsubnet import spiking_fullsubnet_apply
    with torch.no_grad(), mesh if mesh is not None else contextlib.nullcontext():
        out = spiking_fullsubnet_apply(cfg, params, state, x)
    torch.cuda.synchronize()
    return out["enhanced_y"], layer_spikes(out)


def band_step_errors(gk, args, y, stats):
    """``d_step_errors`` for kernel D in band mode: every step recomputed at
    once in float64 from the rank's own y[t-1], its BN sums over the real
    rows summed over the band group through the launch's own collective."""
    xg, whh, b2, bnp, H, shared, rows_real, rows_global, collective = args[:9]
    cy = band_cy(xg, whh, b2, H, shared, y)

    def group_sum(t):
        t = t.contiguous()
        out = collective(t)
        return t if out is None else out

    mean = group_sum(cy[:, :rows_real].sum(1)) / rows_global
    var = group_sum((cy[:, :rows_real] - mean[:, None]).square().sum(1)) / rows_global
    return band_step_report(gk, cy, mean, var, bnp, y, stats)


def band_cy(xg, whh, b2, H, shared, y):
    """Every step's membranes before BN, at once in float64, each step from
    the given y[t-1] (kernel D's own)."""
    yd = y.double()
    zero = torch.zeros_like(yd[:1])
    c_prev = torch.cat([zero, yd[:-1]])
    pre = xg.double() + torch.cat([zero, (yd[:-1] >= 0).double()]) @ whh.double()
    b = b2.double()
    f = torch.sigmoid((pre if shared else pre[..., :H]) + b[0])
    return f * c_prev + (1.0 - f) * ((pre if shared else pre[..., H:]) + b[1])


def band_step_report(gk, cy, mean, var, bnp, y, stats):
    """(max |y - step|, the stats' error in units of the rank's std, the
    flipped spikes, the largest |step| at a flip) of a rank's y and stats
    against the float64 step from its own membranes with the group's mean
    and var."""
    p = bnp.double()
    rstd = torch.rsqrt(var + gk.BN_EPS)
    step = (cy - mean[:, None]) * rstd[:, None] * p[0] + p[1]
    stats_err = max(((stats[:, 0].double() - mean).abs() * rstd).max().item(),
                    ((stats[:, 1].double() - var).abs() / (var + gk.BN_EPS)).max().item())
    yd = y.double()
    flips = (yd >= 0) != (step >= 0)
    n_flips = int(flips.sum().item())
    return ((yd - step).abs().max().item(), stats_err, n_flips,
            step[flips].abs().max().item() if n_flips else 0.0)


def group_step_errors(gk, xgs, whh, b2, bnp, H, shared, rows_real, rows_global, outs):
    """``band_step_errors`` for the ranks of a group on one card: every
    rank's steps from its own y[t-1], the group's sums in rank order.
    Returns the worst of the ranks' (y error, stats error), the flips and
    the largest |step| at one."""
    cys = [band_cy(x, whh, b2, H, shared, o[1]) for x, o in zip(xgs, outs)]
    mean = sum(c[:, :r].sum(1) for c, r in zip(cys, rows_real)) / rows_global
    var = sum((c[:, :r] - mean[:, None]).square().sum(1) for c, r in zip(cys, rows_real)) / rows_global
    reps = [band_step_report(gk, c, mean, var, bnp, o[1], o[2]) for c, o in zip(cys, outs)]
    return (max(r[0] for r in reps), max(r[1] for r in reps), sum(r[2] for r in reps),
            max(r[3] for r in reps))


def band_kernel_checks(gk, d_args, e_args, frames=BAND_CHECK_FRAMES):
    """Kernels D and E in band mode against their plain band versions on the
    arguments of each launch of the counted step, cut to its first
    ``frames`` frames (D is causal, so these are the step's first frames;
    E from there, as phase 6 holds E on a training batch's first frames),
    every rank in turn with the same collective: D over the first WINDOW
    frames (spike mismatch < 1e-3) and step by step from its own state
    (``band_step_errors``, to 3x the plain version's rounding + 1e-4, a
    flipped spike within 1e-3 of the threshold), E (with dW) within
    relative L2 1e-3 (phase 6's bound); each launch timed beside its plain
    version and its bound (``bound_d``, ``bound_e`` on the rank's rows) at
    that length. Returns {"D band": rows, "E band": rows}."""
    per = {"D band": [], "E band": []}
    cut = lambda t: t[:frames].contiguous()  # noqa: E731
    for i, (da, ea) in enumerate(zip(d_args, e_args)):
        da = (cut(da[0]), *da[1:])
        ea = (*[cut(t) for t in ea[:4]], *ea[4:])
        box = []
        ms = cuda_ms(lambda: box.append(gk.gsu_layer_train_fwd_band(*da)), warmup=0)
        plain_ms = cuda_ms(lambda: box.append(gk.layer_train_fwd_band_plain(*da[:9])), warmup=0)
        got, ref = box
        mism = spike_mismatch(got[0][:WINDOW], ref[0][:WINDOW])
        y_err, s_err, n_flips, near = band_step_errors(gk, da, got[1], got[2])
        p_y_err, p_s_err, _, _ = band_step_errors(gk, da, ref[1], ref[2])
        require(mism < 1e-3 and y_err <= 3 * p_y_err + 1e-4 and s_err <= 3 * p_s_err + 1e-4
                and near < 1e-3, f"kernel D band layer {i}: mismatch {mism}, step y {y_err} "
                f"(plain {p_y_err}), stats {s_err} (plain {p_s_err}), flips {n_flips} at {near}")
        xg, whh, b2, bnp, H, shared = da[:6]
        spikes = fired(ea[1])
        nbytes, ops, ops_s = bound_d((xg, whh, b2, bnp, H, shared, "bn"), spikes)
        per["D band"].append({"shape": list(xg.shape), "rows_real": da[6], "rows_global": da[7],
                              "frames": frames,
                              "spike_mismatch": mism, "step_y_err": y_err,
                              "plain_step_y_err": p_y_err, "step_stats_err": s_err,
                              "step_flips": n_flips, "max_abs_err": max_abs(got[1], ref[1]),
                              "ms": ms, "plain_ms": plain_ms,
                              **band_bound(nbytes, ops, ops_s, spikes)})
        del got, ref, box
        box = []
        e_ms = cuda_ms(lambda: box.append(gk.gsu_layer_train_bwd_band(*ea)), warmup=0)
        e_plain_ms = cuda_ms(lambda: box.append(gk.layer_train_bwd_band_plain(*ea[:12])),
                             warmup=0)
        eg = box[0]
        rel = max(band_rel(g, r) for g, r in zip(eg, box[1]))
        require(rel < 1e-3, f"kernel E band layer {i}: relative L2 {rel}")
        nbytes, ops, ops_s = bound_e(tuple(ea[:9]) + ("bn",), spikes)
        per["E band"].append({"shape": list(ea[0].shape), "frames": frames, "rel_l2": rel,
                              "max_abs_err": max_abs(eg, box[1]), "ms": e_ms,
                              "plain_ms": e_plain_ms, **band_bound(nbytes, ops, ops_s, spikes)})
        del eg, box
    return per


def band_rel(got, ref):
    """``rel_l2``, where a rank of only pad rows gives zero outputs: 0 where
    both are zero, inf where only the reference is."""
    if not bool(ref.abs().max() > 0):
        return 0.0 if not bool(got.abs().max() > 0) else float("inf")
    return rel_l2(got, ref)


def band_bound(nbytes, ops, ops_s, spikes):
    row = {"bytes": nbytes, "ops": ops, "spikes": spikes,
           "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ops_ms": ops_s * 1e3, "library_ms": None}
    row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
    return row


def band_rank_main(work, backend, device, data, band):
    """One rank of a band split (``band_ranks_run`` starts it): joins the
    group on ``backend`` (``device`` "cuda" is the rank's own card), lays the
    ranks out as a (``data``, ``band``) mesh, and on its data shard of
    flagship M's batch runs, each counted (every count set to 0 just before,
    read just after): one eval forward (F 4 launches) and one step
    (``band_step``: D and E in band mode 6 launches each, D and E 2 each for
    the fullband, dW 8), with the collectives of the step; then the eval
    timed once more, and on the peer route (whose first step sets the
    group's exchange up) four more steps: as built, with the host waiting
    for every band launch (``band_launches_synced``), then both again;
    then ``band_kernel_checks`` on the step's own launches.
    Writes <work>/band_rank<r>.pt (outputs, weights, state) and .json."""
    import os
    from datetime import timedelta

    import torch.distributed as tdist

    from spiking_fullsubnet_torch.ops import gsu_kernels as gk
    from spiking_fullsubnet_torch.parallel import dist
    from spiking_fullsubnet_torch.parallel.mesh import band_setup_of, make_mesh, shard_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work, rank, data, band = Path(work), int(os.environ["RANK"]), int(data), int(band)
    require(dist.initialize_distributed(backend=backend, device=device,
                                        timeout=timedelta(seconds=DIST_GROUP_TIMEOUT)),
            "rank joined no group")
    dev = dist.rank_device(device)
    torch.cuda.set_device(dev)
    gk.build_kernels()  # the libraries the parent built
    mesh = make_mesh(("data", "band"), (data, band))
    cfg, params, state = band_model(dev)
    noisy, clean = shard_batch(mesh, band_batch(data * BAND_B, dev))
    calls = {"all_reduce": 0, "all_gather": 0}
    real = {k: getattr(tdist, k) for k in calls}

    def counted(name):
        def wrapped(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return wrapped

    band_zero(gk)
    y, spikes = band_eval(cfg, params, state, noisy, mesh)
    eval_counts = band_counts(gk)
    box = []
    band_zero(gk)
    # each band launch of the step: the collectives while it runs (none on
    # the peer route) and its ms (CUDA events around the wrapper)
    inside, events = {"collectives": 0}, {k: [] for k in BAND_WRAPPERS}
    originals = {k: getattr(gk, n) for k, n in BAND_WRAPPERS.items()}

    def probe(key):
        def wrapped(*a, **kw):
            before = sum(calls.values())
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = originals[key](*a, **kw)
            ev[1].record()
            events[key].append(ev)
            inside["collectives"] += sum(calls.values()) - before
            return out
        wrapped.launches = 0  # the wrapper counts through its module's name
        return wrapped

    probes = {k: probe(k) for k in BAND_WRAPPERS}
    for k, n in BAND_WRAPPERS.items():
        setattr(gk, n, probes[k])
    for k in calls:
        setattr(tdist, k, counted(k))
    t0 = time.perf_counter()
    try:
        seen = record_calls(gk, list(BAND_WRAPPERS.values()),
                            lambda: box.append(band_step(cfg, params, state, noisy, clean, mesh)),
                            keep_counts=True)
    finally:
        for k in calls:
            setattr(tdist, k, real[k])
        for k, n in BAND_WRAPPERS.items():
            originals[k].launches += probes[k].launches
            setattr(gk, n, originals[k])
    step_ms = (time.perf_counter() - t0) * 1e3  # band_step ends in a synchronise
    step_counts = band_counts(gk)
    launch_ms = {k: [a.elapsed_time(b) for a, b in evs] for k, evs in events.items()}
    setup = band_setup_of(mesh.get_group("band"))
    route = setup.route if setup is not None else None
    step2_ms, again_ms = None, None
    if route == "peer":
        require(inside["collectives"] == 0,
                f"rank {rank}: {inside['collectives']} collectives inside D and E band on the "
                "peer route")
        # the first step sets the group's exchange up: later ones, timed
        # alone, as built (the exchange's error record read once a step)
        # and with the host waiting for every band launch, as a blocking
        # read of each launch's record would, in turn
        again_ms = {"deferred": [], "synced": []}
        for kind in ("deferred", "synced") * 2:
            with band_launches_synced(gk, kind == "synced"):
                t0 = time.perf_counter()
                band_step(cfg, params, state, noisy, clean, mesh)
                again_ms[kind].append((time.perf_counter() - t0) * 1e3)
        step2_ms = again_ms["deferred"][0]
    step = box[0]
    eval_ms = cuda_ms(lambda: band_eval(cfg, params, state, noisy, mesh), warmup=0)
    detach = lambda a: tuple(t.detach() if isinstance(t, torch.Tensor) else t for t in a)  # noqa: E731
    d_args = [detach(a) for a, _ in seen[BAND_WRAPPERS["D band"]]]
    e_args = [detach(a) for a, _ in seen[BAND_WRAPPERS["E band"]]]
    # E's launches in D's order: E receives the xg that D read
    e_args = [next(e for e in e_args if e[0].data_ptr() == d[0].data_ptr()) for d in d_args]
    checks = band_kernel_checks(gk, d_args, e_args)
    torch.save({"y": y.cpu(), "spikes": [s.cpu() for s in spikes],
                "weights": [w.cpu() for w in step["weights"]],
                "state": [s.cpu() for s in step["state"]], "grads": step["grads"].cpu(),
                "own_grads": step["own"].cpu(),
                "train_spikes": [s.cpu() for s in step["spikes"]]},
               work / f"band_rank{rank}.pt")
    (work / f"band_rank{rank}.json").write_text(json.dumps({
        "rank": rank, "device": str(dev), "coordinate": [mesh.get_local_rank("data"),
                                                         mesh.get_local_rank("band")],
        "groups": {a: tdist.get_process_group_ranks(mesh.get_group(a)) for a in ("data", "band")},
        "eval_launches": eval_counts, "step_launches": step_counts, "collectives": calls,
        "route": route, "why": setup.why if setup is not None else None,
        "setup_s": setup.seconds if setup is not None else None, "step2_ms": step2_ms,
        "again_ms": again_ms,
        "collectives_inside_band": inside["collectives"], "band_launch_ms": launch_ms,
        "loss": step["loss"], "grad_norm": step["norm"], "eval_ms": eval_ms, "step_ms": step_ms,
        "kernels": checks}))
    dist.shutdown()
    print(f"BAND_RANK_OK {rank}", flush=True)


def band_reference(dev, data, rows_of):
    """This process on ``dev``: for each data shard (``rows_of(k)``), the
    unsharded eval forward and step (each timed: the eval by CUDA events,
    the step by the host clock to its synchronise; the second shard's, or a
    second run of the first where there is one shard). Returns (evals,
    steps, the initial weights, ``update(grads)``: clip and AdamW's step from
    the initial weights on flat gradients, timings)."""
    from spiking_fullsubnet_torch.recipes.denoise import adamw
    from spiking_fullsubnet_torch.runtime.trainer import optimizer_update

    cfg, params, state = band_model(dev)
    noisy, clean = band_batch(data * BAND_B, dev)
    evals, steps, timing = [], [], {}
    for k in range(max(data, 2)):
        rows = rows_of(k % data)
        timing["eval_ms"] = cuda_ms(lambda: evals.append(band_eval(cfg, params, state,
                                                                   noisy[rows])), warmup=0)
        t0 = time.perf_counter()
        steps.append(band_step(cfg, params, state, noisy[rows], clean[rows]))
        timing["step_ms"] = (time.perf_counter() - t0) * 1e3

    def update(grads):
        p = fresh(params)
        leaves = tensors_of(p)
        opt = adamw(leaves, BAND_LR)
        offset = 0
        for t in leaves:
            t.grad = grads[offset:offset + t.numel()].view_as(t).to(t).clone()
            offset += t.numel()
        optimizer_update(opt, BAND_CLIP)
        return [t.detach() for t in leaves]

    return (evals[:data], steps[:data], [t.detach() for t in tensors_of(params)], update,
            timing)


@contextlib.contextmanager
def band_launches_synced(gk, on):
    """With ``on``, the host waits for the stream after every launch of D
    and E band (``BAND_WRAPPERS``); their counts are left as they were."""
    if not on:
        yield
        return
    real = {n: getattr(gk, n) for n in BAND_WRAPPERS.values()}

    def synced(fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            torch.cuda.current_stream().synchronize()
            return out
        wrapped.launches = 0  # the wrapper counts through its module's name
        return wrapped

    for n, fn in real.items():
        setattr(gk, n, synced(fn))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(gk, n, fn)


def band_ranks_run(work, ranks, band, backend, device, ref_dev, tag, meanwhile=None,
                   route=None):
    """``ranks`` processes (``python3 chip_smoke.py --band-rank``) on a
    (ranks / band, band) mesh, then ``band_reference`` here: within a band
    group the output and the state bit for bit, and every rank's updated
    weights bit for bit; the reduction against the ranks' own gradients;
    each data rank's eval output (every layer's spikes per layer < 1e-3
    apart, audio relative L2 < 0.05: phase 10's bounds of the fused route)
    and step (loss, state, gradients: BAND_* above, by whether its training
    spikes equal the unsharded run's) against the unsharded one of its
    shard, and the update against clip and AdamW on the ranks' own reduced
    gradients; each rank's launches: F 4 in eval, D and E 2 and their band
    modes 6, dW 8 in the step; every rank on the band route ``route`` where
    given (``parallel/mesh.band_route``). ``meanwhile()`` runs here while
    the ranks do. Returns the numbers."""
    data = ranks // band
    port = str(free_port())
    procs = [start_process([sys.executable, str(Path(__file__).resolve()), "--band-rank",
                            str(work), backend, device, str(data), str(band)],
                           Path(work) / f"band_rank{r}.log",
                           {"RANK": str(r), "WORLD_SIZE": str(ranks), "LOCAL_RANK": str(r),
                            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port})
             for r in range(ranks)]
    res = {"meanwhile": meanwhile() if meanwhile else None}
    done = wait_processes(procs, BAND_TIMEOUT)
    for r, (rc, secs, tail) in enumerate(done):
        log(f"[band] {tag} rank {r}: exit {rc} after {secs:.1f} s")
    failed = [(r, rc, tail) for r, (rc, _, tail) in enumerate(done) if rc != 0]
    failed.sort(key=lambda f: f[1] == -9)  # a rank that failed first, not one killed after it
    require(not failed, "; ".join(f"{tag} rank {r} exited {rc}:\n{tail}" for r, rc, tail in failed))
    recs = [json.loads((Path(work) / f"band_rank{r}.json").read_text()) for r in range(ranks)]
    for rec in recs:
        log(f"[band] {tag} rank {rec['rank']} on {rec['device']}: route {rec['route']} "
            f"({rec['why']}; set up in {rec['setup_s']:.3f} s); step {rec['step_ms']:.1f} ms, "
            f"again {rec['step2_ms']} ms ({rec['again_ms']}); collectives inside D and E band "
            f"{rec['collectives_inside_band']}; "
            f"band launches' ms " + ", ".join(f"{k} {[round(v, 3) for v in ms]}"
                                               for k, ms in rec["band_launch_ms"].items()))
    require(route is None or all(rec["route"] == route for rec in recs),
            f"{tag}: routes {[rec['route'] for rec in recs]}, expected {route}")
    outs = [torch.load(Path(work) / f"band_rank{r}.pt", weights_only=True) for r in range(ranks)]
    evals, steps, w0, update, timing = band_reference(
        ref_dev, data, lambda k: slice(k * BAND_B, (k + 1) * BAND_B))
    w_ref = update(sum(st["grads"] for st in steps) / data)
    flat = lambda ts: torch.cat([t.flatten().double().cpu() for t in ts])  # noqa: E731
    # the reduction: every rank's gradients are its band group's own
    # gradients summed, averaged over the data groups; each data group's sum
    # against this process's gradients of its shard
    coords = [tuple(rec["coordinate"]) for rec in recs]
    group_sum = [sum(o["own_grads"].double() for o, c in zip(outs, coords) if c[0] == d)
                 for d in range(data)]
    want_grads = sum(group_sum) / data
    res["reduce_rel_l2"] = [rel_l2(o["grads"], want_grads) for o in outs]
    res["grad_rel_l2"] = [rel_l2(g, steps[d]["grads"].cpu()) for d, g in enumerate(group_sum)]
    log(f"[band] {tag}: the reduction against the ranks' own gradients {res['reduce_rel_l2']}; "
        f"each data group's summed gradients against this process's "
        f"{res['grad_rel_l2']} (relative L2)")
    require(max(res["reduce_rel_l2"]) < 1e-6, f"{tag}: reduce_gradients {res['reduce_rel_l2']}")
    want_eval = dict(train_launches(0), F=4, **{k: 0 for k in BAND_WRAPPERS})
    want_step = dict(train_launches(2), dW=8, **{k: 6 for k in BAND_WRAPPERS})
    res.update(ranks=recs, reference=timing, by_rank=[])
    w_own = update(outs[0]["grads"].to(ref_dev))  # the update from the ranks' own gradients
    for r, (rec, out) in enumerate(zip(recs, outs)):
        d, b = rec["coordinate"]
        head = outs[d * band]
        require(torch.equal(out["y"], head["y"]) and tensors_equal(out["state"], head["state"]),
                f"{tag}: band rank {b} of data rank {d} differs from band rank 0")
        require(tensors_equal(out["weights"], outs[0]["weights"]),
                f"{tag}: rank {r}'s updated weights differ from rank 0's")
        require(rec["eval_launches"] == want_eval and rec["step_launches"] == want_step,
                f"{tag} rank {r}: launches {rec['eval_launches']} {rec['step_launches']}")
        y_ref, s_ref = evals[d]
        ref = steps[d]
        step_rel = lambda w: float(torch.linalg.vector_norm(flat(out["weights"]) - flat(w))  # noqa: E731
                                   / torch.linalg.vector_norm(flat(w) - flat(w0)))
        res["by_rank"].append({
            "rank": r, "spike_mismatch": [spike_mismatch(a, bb.cpu())
                                          for a, bb in zip(out["spikes"], s_ref)],
            "audio_rel_l2": rel_l2(out["y"], y_ref.cpu()),
            "train_spike_mismatch": [spike_mismatch(a, bb.cpu()) for a, bb in
                                     zip(out["train_spikes"], ref["spikes"])],
            "loss_rel": abs(rec["loss"] - ref["loss"]) / abs(ref["loss"]),
            "state_rel_l2": rel_l2(flat(out["state"]), flat(ref["state"])),
            "grad_rel_l2": res["grad_rel_l2"][d], "update_rel_l2": step_rel(w_ref),
            "update_own_rel_l2": step_rel(w_own)})
    log(f"[band] {tag} against the unsharded run: {res['by_rank']}")
    for row in res["by_rank"]:
        require(max(row["spike_mismatch"]) < 1e-3 and row["audio_rel_l2"] < 0.05,
                f"{tag} rank {row['rank']} eval against the unsharded forward: {row}")
        require(row["update_own_rel_l2"] < BAND_OWN_REL,
                f"{tag} rank {row['rank']}: the update from its own gradients: {row}")
        if max(row["train_spike_mismatch"]) == 0:  # the unsharded run's trajectory
            require(row["loss_rel"] < BAND_LOSS_REL and row["state_rel_l2"] < BAND_STATE_REL
                    and row["grad_rel_l2"] < BAND_GRAD_REL,
                    f"{tag} rank {row['rank']} step against the unsharded step: {row}")
        else:  # a flip, carried by the batch statistics (logged, as phase 6 logs D's drift)
            require(row["loss_rel"] < BAND_FLIP_LOSS_REL
                    and max(row["train_spike_mismatch"]) < BAND_FLIP_SPIKES,
                    f"{tag} rank {row['rank']} step against the unsharded step: {row}")
    res["process_s"] = [s for _, s, _ in done]
    return res


def band_nccl_world_one(dev):
    """Phase 16 (a): NCCL at world size 1 in this process, a (1, 1) mesh:
    flagship M's fused eval forward and one step with ``band_axis`` set
    under the mesh are bit for bit those without a mesh."""
    import torch.distributed as tdist

    from spiking_fullsubnet_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(dev if dev.index is not None else 0)
    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                             world_size=1)
    try:
        mesh = make_mesh(("data", "band"), (1, 1))
        cfg, params, state = band_model(dev)
        noisy, clean = band_batch(BAND_B, dev)
        y0, s0 = band_eval(cfg, params, state, noisy)
        y1, s1 = band_eval(cfg, params, state, noisy, mesh)
        a, b = band_step(cfg, params, state, noisy, clean), band_step(cfg, params, state, noisy,
                                                                      clean, mesh)
    finally:
        tdist.destroy_process_group()
    same_eval = torch.equal(y0, y1) and all(torch.equal(p, q) for p, q in zip(s0, s1))
    same_step = (a["loss"] == b["loss"] and a["norm"] == b["norm"]
                 and all(tensors_equal(a[k], b[k]) for k in ("weights", "state", "grads")))
    require(same_eval and same_step, f"phase 16 (a): eval equal {same_eval}, step equal {same_step}")
    return {"eval_bitwise": same_eval, "step_bitwise": same_step, "loss": a["loss"]}


BAND_GROUPS = (2, 4)  # phase 16 (c): band groups of ranks on one card
BAND_GROUP_BF16 = 1  # (c): the section also held with bf16 streams (the ragged one)
BAND_GROUP_E_REL = {torch.float32: 1e-3, torch.bfloat16: 1e-2}
BAND_GROUP_WRAPPERS = {"D band": "gsu_layer_train_fwd_band_group",
                       "E band": "gsu_layer_train_bwd_band_group"}
BAND_GUARD_S = 0.5  # (c): the hang guard's limit for the launch whose peer never writes


def band_section_layers(gk, dev):
    """Flagship M's six section layers (phase 16's model and rows, 8 x 2 s)
    as one unsharded training step gives them to kernels D and E: [(section,
    layer, D's arguments, E's)], each layer's rows in (utterance, unit)
    order, f32 streams."""
    cfg, params, state = band_model(dev)
    noisy, clean = band_batch(BAND_B, dev)
    names = [TRAIN_WRAPPERS["D"], TRAIN_WRAPPERS["E"]]
    seen = record_calls(gk, names, lambda: band_step(cfg, params, state, noisy, clean))
    detach = lambda a: tuple(t.detach() if isinstance(t, torch.Tensor) else t for t in a)  # noqa: E731
    d_all = [detach(a) for a, _ in seen[names[0]]]
    e_all = [detach(a) for a, _ in seen[names[1]]]
    d_sec = [d for d in d_all if d[0].shape[1] != BAND_B]  # the fullband's rows are B
    require(len(d_sec) == 6, f"flagship M's section layers: {len(d_sec)} launches of D")
    return [(i // 2, i % 2, d, next(e for e in e_all if e[0].data_ptr() == d[0].data_ptr()))
            for i, d in enumerate(d_sec)]


def band_split_rows(t, N, G):
    """A section layer's rows ``t [T, B N, X]`` in (utterance, unit) order
    as the band split lays them on G ranks: the units padded to a multiple
    of G, rank k's units k per .. k per + per - 1 as rows in (unit,
    utterance) order (``models/spiking_fullsubnet._band_sections``), pad
    rows zero. Returns (each rank's rows, each rank's real rows)."""
    T, BN, X = t.shape
    B, per = BN // N, -(-N // G)
    u = torch.nn.functional.pad(t.reshape(T, B, N, X).transpose(1, 2), (0, 0, 0, 0, 0, per * G - N))
    parts = [u[:, k * per:(k + 1) * per].reshape(T, per * B, X).contiguous() for k in range(G)]
    return parts, [max(0, min(N, (k + 1) * per) - k * per) * B for k in range(G)]


def band_group_layer(gk, G, exchange, d, e, io, frames):
    """One section layer on the group route: kernel D band and E band (with
    dW) for G ranks in one launch each, against their plain band versions
    in lockstep on the same inputs: D's spikes over the first WINDOW frames
    (< 1e-3 apart), its steps from its own membranes (``group_step_errors``:
    3x the plain version's rounding + 1e-4, flips within 1e-3 of the
    threshold), every rank's stats bit for bit equal; E and dW on D's
    outputs within relative L2 ``BAND_GROUP_E_REL``. Each launch timed
    beside its plain version and its bound (the G ranks' work)."""
    xg, whh, b2, bnp, H, shared, _ = d
    gout = e[2]
    N = xg.shape[1] // BAND_B
    xgs, real = band_split_rows(xg[:frames].to(io), N, G)
    gouts, _ = band_split_rows(gout[:frames].to(io), N, G)
    whh = whh.to(io)
    args = (whh, b2, bnp, H, shared, real, N * BAND_B)
    box = []
    ms = cuda_ms(lambda: box.append(gk.gsu_layer_train_fwd_band_group(xgs, *args, exchange)),
                 warmup=0)
    plain_ms = cuda_ms(lambda: box.append(gk.layer_train_fwd_band_group_plain(xgs, *args)),
                       warmup=0)
    got, ref = box
    mism = max(spike_mismatch(g[0][:WINDOW], r[0][:WINDOW]) for g, r in zip(got, ref))
    y_err, s_err, n_flips, near = group_step_errors(gk, xgs, *args, got)
    p_y_err, p_s_err, _, _ = group_step_errors(gk, xgs, *args, ref)
    same_stats = all(torch.equal(g[2], got[0][2]) for g in got)
    where = f"G {G} section {N} units {io}"
    require(mism < 1e-3 and y_err <= 3 * p_y_err + 1e-4 and s_err <= 3 * p_s_err + 1e-4
            and near < 1e-3 and same_stats,
            f"kernel D band, group route, {where}: mismatch {mism}, step y {y_err} (plain "
            f"{p_y_err}), stats {s_err} (plain {p_s_err}), flips {n_flips} at {near}, stats "
            f"equal across ranks {same_stats}")
    spikes = [fired(g[1]) for g in got]
    b = [bound_d((x, whh, b2, bnp, H, shared, "bn"), sp) for x, sp in zip(xgs, spikes)]
    d_row = {"G": G, "io": str(io).replace("torch.", ""), "shape": list(xgs[0].shape),
             "rows_real": real, "frames": frames, "spike_mismatch": mism, "step_y_err": y_err,
             "plain_step_y_err": p_y_err, "step_stats_err": s_err, "step_flips": n_flips,
             "stats_bitwise_across_ranks": same_stats,
             "max_abs_err": max(max_abs(g[1], r[1]) for g, r in zip(got, ref)), "ms": ms,
             "plain_ms": plain_ms, **band_bound(sum(x[0] for x in b), sum(x[1] for x in b),
                                               sum(x[2] for x in b), sum(spikes))}
    ys, statss = [g[1] for g in got], [g[2] for g in got]
    del ref, box
    box = []
    e_args = (xgs, ys, gouts, statss, whh, b2, bnp, H, shared, real, N * BAND_B)
    e_ms = cuda_ms(lambda: box.append(gk.gsu_layer_train_bwd_band_group(*e_args, exchange)),
                   warmup=0)
    e_plain_ms = cuda_ms(lambda: box.append(gk.layer_train_bwd_band_group_plain(*e_args)),
                         warmup=0)
    rel = max(band_rel(a, r) for g, p in zip(*box) for a, r in zip(g, p))
    require(rel < BAND_GROUP_E_REL[io], f"kernel E band, group route, {where}: relative L2 {rel}")
    b = [bound_e((x, yy, go, st, whh, b2, bnp, H, shared, "bn"), sp)
         for x, yy, go, st, sp in zip(xgs, ys, gouts, statss, spikes)]
    e_row = {"G": G, "io": d_row["io"], "shape": d_row["shape"], "frames": frames,
             "rel_l2": rel, "max_abs_err": max(max_abs(a, r) for g, p in zip(*box)
                                               for a, r in zip(g, p)),
             "ms": e_ms, "plain_ms": e_plain_ms,
             **band_bound(sum(x[0] for x in b), sum(x[1] for x in b), sum(x[2] for x in b),
                          sum(spikes))}
    return d_row, e_row, (xgs, args)


def band_group_phase(gk, dev, frames=BAND_CHECK_FRAMES):
    """Phase 16 (c): kernels D and E in band mode on the group route, G ranks
    of a band group as clusters of one launch on this card (``gk.
    gsu_layer_train_fwd_band_group``, ``_bwd_band_group``), for G in
    BAND_GROUPS at flagship M's six section layers (one unsharded step's
    arguments, their rows split as the band split lays them, the first
    ``frames`` frames) with f32 streams, and the BAND_GROUP_BF16 section's
    two layers with bf16 streams; each layer held by ``band_group_layer``.
    After one uncounted warm-up layer, counted (set to 0 just before, read
    just after): one D band and one E band launch a layer, no collective.
    Then a launch whose peer never
    writes (rank 1 of a group of 2 left out of the launch) raises within
    the hang guard's BAND_GUARD_S. Returns the rows and counts."""
    import torch.distributed as tdist

    layers = band_section_layers(gk, dev)
    calls = {"all_reduce": 0, "all_gather": 0}
    real = {k: getattr(tdist, k) for k in calls}

    def counted(name):
        def wrapped(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return wrapped

    out = {"D band": [], "E band": [], "launches": {}, "route": "group"}
    # the first group launch in a process pays a one-time cost (165 ms more
    # than the next on an H100, not traced): one layer of each before the
    # counted and timed run
    _, _, d0, e0 = layers[0]
    band_group_layer(gk, BAND_GROUPS[0], gk.group_exchange(dev, BAND_GROUPS[0]), d0, e0,
                     torch.float32, WINDOW)
    for k, n in BAND_GROUP_WRAPPERS.items():
        getattr(gk, n).launches = 0
    for k in calls:
        setattr(tdist, k, counted(k))
    try:
        for G in BAND_GROUPS:
            ex = gk.group_exchange(dev, G)  # one counter over all the layers of G
            cases = [(d, e, torch.float32) for _, _, d, e in layers]
            cases += [(d, e, torch.bfloat16) for sec, _, d, e in layers if sec == BAND_GROUP_BF16]
            for d, e, io in cases:
                d_row, e_row, last = band_group_layer(gk, G, ex, d, e, io, frames)
                out["D band"].append(d_row)
                out["E band"].append(e_row)
    finally:
        for k in calls:
            setattr(tdist, k, real[k])
    out["launches"] = {k: getattr(gk, n).launches for k, n in BAND_GROUP_WRAPPERS.items()}
    out["collectives"] = dict(calls)
    n_layers = len(out["D band"])
    require(out["launches"] == {"D band": n_layers, "E band": n_layers}
            and sum(calls.values()) == 0,
            f"phase 16 (c): launches {out['launches']} for {n_layers} layers, collectives {calls}")
    # the hang guard: rank 0 of a group of 2 launched alone
    xgs, args = last
    ex = gk.group_exchange(dev, 2)
    ex.timeout_s = BAND_GUARD_S
    t0 = time.perf_counter()
    try:
        gk._fwd_band_launch(xgs[:1], *args[:5], args[5][:1], args[6], ex, 0)
        ex.check()  # the wrapper reads the record without waiting; this waits
        raised = ""
    except RuntimeError as err:
        raised = str(err)
    out["guard"] = {"limit_s": BAND_GUARD_S, "raised_after_s": time.perf_counter() - t0,
                    "message": raised}
    require("waited past" in raised and out["guard"]["raised_after_s"] < BAND_GUARD_S + 10,
            f"phase 16 (c): the launch with an absent peer: {out['guard']}")
    return out


def band_phase(gk, dev):
    """Phase 16 (see the module docstring); returns its numbers."""
    import shutil
    import tempfile

    torch.set_grad_enabled(True)
    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_band_"))
    try:  # (a) here while (b)'s ranks run
        out = {"b": band_ranks_run(work, 2, 2, "gloo", "cuda:0", dev, "phase 16 (b)",
                                   lambda: band_nccl_world_one(dev), route="staged")}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["a"] = out["b"].pop("meanwhile")
    t_c = time.perf_counter()
    out["c"] = band_group_phase(gk, dev)
    out["c"]["seconds"] = time.perf_counter() - t_c
    torch.set_grad_enabled(False)
    out["seconds"] = time.perf_counter() - t_phase
    b = out["b"]
    r0 = b["ranks"][0]
    log(f"[band] phase 16 on {card_name()}: (a) NCCL at world size 1, a (1, 1) mesh: eval and "
        f"step bitwise equal to no mesh; (b) 2 gloo ranks on cuda:0, flagship M {BAND_B} x "
        f"{BAND_SECONDS:g} s: eval {[r['eval_ms'] for r in b['ranks']]} ms a rank (unsharded "
        f"{b['reference']['eval_ms']:.1f}), step {[r['step_ms'] for r in b['ranks']]} ms a rank "
        f"(unsharded {b['reference']['step_ms']:.1f}); collectives a step {r0['collectives']}; "
        f"launches eval {r0['eval_launches']}, step {r0['step_launches']}; against the "
        f"unsharded run {b['by_rank']}; phase {out['seconds']:.1f} s")
    for k in BAND_WRAPPERS:
        for i, row in enumerate(r0["kernels"][k]):
            log(f"[band] (b) staged {k} launch {i} {tuple(row['shape'])}: {row['ms']:.3f} ms "
                f"(plain {row['plain_ms']:.1f}, bound {row['bound_ms']:.4f}), "
                + ", ".join(f"{f} {row[f]:.3e}" for f in ("spike_mismatch", "step_y_err",
                                                           "rel_l2", "max_abs_err") if f in row))
    c = out["c"]
    for k in BAND_GROUP_WRAPPERS:
        for row in c[k]:
            log(f"[band] (c) group route {k} G {row['G']} {row['io']} {tuple(row['shape'])}: "
                f"{row['ms']:.3f} ms (plain {row['plain_ms']:.1f}, bound {row['bound_ms']:.4f}), "
                + ", ".join(f"{f} {row[f]:.3e}" for f in ("spike_mismatch", "step_y_err",
                                                           "plain_step_y_err", "rel_l2",
                                                           "max_abs_err") if f in row))
    log(f"[band] (c) launches {c['launches']}, collectives {c['collectives']}; the hang guard "
        f"raised after {c['guard']['raised_after_s']:.2f} s (limit {BAND_GUARD_S} s): "
        f"{c['guard']['message']}; (c) {c['seconds']:.1f} s")
    return out


BAND_SOURCES = {"D band": "gsu_train_fwd.cu", "E band": "gsu_train_bwd.cu"}


def add_band_rows(kernels, rec):
    """Kernels D and E in band mode: the staged route under the wrappers'
    names (rank 0's launches in phase 16 (b)'s step, and the
    sums over its six launches' checks), then the redesigned kernels on the
    group route (phase 16 (c): its launches; ms, plain ms and bound the
    sums over the six f32 section layers at G = 2, each launch two ranks'
    work on this one card)."""
    r0 = rec["b"]["ranks"][0]
    for k, (name, line) in BAND_META.items():
        rows = r0["kernels"][k]
        t = sums_of(rows)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "spiking_fullsubnet_torch/csrc/gsu_train_band.cu",
            "replaces": f"spiking_fullsubnet_tpu/ops/gsu_pallas.py:{line}",
            "launches": r0["step_launches"][k],
            "max_abs_err": max(row["max_abs_err"] for row in rows),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "per_launch": rows})
    c = rec["c"]
    for k, (name, line) in BAND_META.items():
        rows = c[k]
        t = sums_of([r for r in rows if r["G"] == BAND_GROUPS[0] and r["io"] == "float32"])
        kernels.append({
            "name": f"{name} group ({BAND_GROUPS[0]} ranks a launch)", "route": "cuda",
            "source": f"spiking_fullsubnet_torch/csrc/{BAND_SOURCES[k]}",
            "replaces": f"spiking_fullsubnet_tpu/ops/gsu_pallas.py:{line}",
            "launches": c["launches"][k],
            "max_abs_err": max(row["max_abs_err"] for row in rows),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "per_launch": rows})


# ------------------------------------------------------------------ phase 17: the tools

MATMUL_N = 8192  # (a): the timer's matmul
ROOF_B, ROOF_SECONDS = 4, 30.0  # (b): the flagship forward the roofline reads
PROF_B, PROF_SECONDS = 8, 2.0  # (d): profile_trace's serving batch
# (e): the N-DNS set's utterances are 30 s, and its dataset pads a shorter
# item to 30 s with zeros (data/dns_audio.py, as the JAX package's), which a
# row's SI-SNR would then read
BOARD_UTTS, BOARD_SECONDS = 5, 30.0
# (e): zoo M's shipped config over baseline_m.toml's, the widths the same:
# the weights' own norm, no pre-LayerNorm, the Separator's fullband input
# (its frequency groups) and the layered forward (separator_config's; the
# fused scan takes no norm)
BOARD_ZOO_M = dict(norm_type="offline_laplace_norm", use_pre_layer_norm_fb=False,
                   use_pre_layer_norm_sb=False, fb_center_freq_sizes=[4, 32, 64],
                   fb_neighbor_freq_sizes=[0, 0, 0], scan_mode="layered")
ZOO_UTTS = 8  # (f)
ZOO_M_PARAMS, ZOO_M_SISNR, ZOO_SISNR_TOL = 953_704, 14.88, 0.25  # entries_framework.json
TOOL_KERNELS = {"C": "sfsb_monolith_serve", "D": "gsu_layer_train_fwd",
                "E": "gsu_layer_train_bwd", "dW": "gsu_train_dw"}


def quiet_main(main, argv):
    """``main(argv)`` with its printed lines kept: (its result, the lines)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = main([str(a) for a in argv])
    return res, buf.getvalue().splitlines()


def write_reference_zoo(root, size):
    """A tree of the reference zoo's layout for ``baseline_<size>``: the
    freeze-phase recipe's [model.args] as its shipped [model_g.args], and
    the in-repo weights under the reference's names as its generator."""
    from spiking_fullsubnet_torch.runtime.config import toml_dump, toml_load
    from spiking_fullsubnet_torch.runtime.convert import load_npz, reference_state_dict

    d = root / f"baseline_{size}"
    (d / "checkpoints" / "best").mkdir(parents=True)
    args = toml_load(FREEZE_RECIPE / f"baseline_{size}.toml")["model"]["args"]
    toml_dump({"model_g": {"args": args}}, d / f"config__baseline_{size}.toml")
    tree = load_npz(str(ZOO_M.parent / f"baseline_{size}.npz"), device="cpu")
    torch.save(reference_state_dict(tree["params"], tree["state"]),
               d / "checkpoints" / "best" / "pytorch_model.bin")
    return root


def board_tree(root):
    """BOARD_UTTS DNS-named utterances of BOARD_SECONDS (the zoo tool's
    speech-like fixture) under noisy/ and clean/."""
    from spiking_fullsubnet_torch.dsp.io import save_wav
    from spiking_fullsubnet_torch.tools.build_model_zoo import speechlike_fixture

    for d in ("noisy", "clean"):
        (root / d).mkdir(parents=True)
    for fid, (clean, noisy) in enumerate(speechlike_fixture(BOARD_UTTS, BOARD_SECONDS)):
        save_wav(noisy, root / "noisy" / f"book_snr10_tl-25_fileid_{fid}.wav", SR)
        save_wav(clean, root / "clean" / f"clean_fileid_{fid}.wav", SR)
    return root


def tools_phase(gk, dev):
    """Phase 17 (see the module docstring); returns its numbers."""
    import importlib.util
    import shutil
    import tempfile

    from spiking_fullsubnet_torch.models.presets import flagship_m
    from spiking_fullsubnet_torch.runtime import cli, roofline, timing
    from spiking_fullsubnet_torch.runtime.config import toml_dump, toml_load
    from spiking_fullsubnet_torch.runtime.convert import load_npz, reference_state_dict
    from spiking_fullsubnet_torch.tools import (bench_gsu_kernel, build_model_zoo,
                                                calculate_metrics, profile_trace,
                                                reproduce_board)

    t_phase = time.perf_counter()
    smi = card_name()
    out = {}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_tools_"))
    try:
        # (a) the timer on a bf16 matmul
        torch.set_grad_enabled(False)
        g = torch.Generator(device=dev).manual_seed(17)
        a = torch.randn(MATMUL_N, MATMUL_N, device=dev, dtype=torch.bfloat16, generator=g)
        b = torch.randn(MATMUL_N, MATMUL_N, device=dev, dtype=torch.bfloat16, generator=g)
        s = timing.time_fn_per_iter(torch.matmul, (a, b))
        out["a"] = {"ms": s * 1e3, "tflops": 2 * MATMUL_N ** 3 / s / 1e12}
        del a, b
        log(f"[tools] (a) time_fn_per_iter, bf16 {MATMUL_N}^3 matmul on {smi}: "
            f"{out['a']['ms']:.4f} ms, {out['a']['tflops']:.1f} TFLOP/s")
        require(100 < out["a"]["tflops"] <= 989, f"the timer's matmul rate {out['a']}")

        # (b) the roofline of flagship M at the timer's throughput
        flag = flagship_m(device=dev, scan_mode="auto", compute_dtype="bfloat16",
                          collect_layer_outputs=False)
        cfg, params, state = flag["config"], flag["params"], flag["state"]
        x = torch.from_numpy((np.random.default_rng(0).standard_normal(
            (ROOF_B, int(ROOF_SECONDS * SR))) * 0.1).astype(np.float32)).to(dev)
        before = launch_counts(gk)["C"]
        s = timing.time_fn_per_iter(lambda x: flag["apply"](cfg, params, state, x)["enhanced_y"],
                                    (x,), iters=(1, 3), reps=2)
        rate = ROOF_B * ROOF_SECONDS / s
        rep = roofline.roofline_report(cfg, rate)
        out["b"] = {"forward_ms": s * 1e3, "audio_s_per_s": rate, "report": rep,
                    "c_launches": launch_counts(gk)["C"] - before}
        del flag, params, state, x
        log(f"[tools] (b) flagship M bf16 {ROOF_B} x {ROOF_SECONDS:g} s: {s * 1e3:.3f} ms a "
            f"forward ({rate:.1f} audio-s/s; C launched {out['b']['c_launches']} times); "
            f"roofline_report: " + ", ".join(f"{k} {v:.6g}" if isinstance(v, float) else
                                             f"{k} {v}" for k, v in rep.items()))
        require(out["b"]["c_launches"] > 0, "the roofline's forward did not launch kernel C")
        require(0 < rep["mfu"] <= 1 and 0 < rep["fraction_of_roofline"] <= 1,
                f"roofline_report {rep}")

        # (c) the kernel bench at its defaults, with the gradient
        res, lines = quiet_main(bench_gsu_kernel.main, ["--train"])
        out["c"] = res
        for line in lines:
            log(f"[tools] (c) {line}")
        ck = res["checks"]
        require(ck["d_spike_mismatch_head"] < 1e-3, f"bench_gsu_kernel: kernel D {ck}")
        require(ck["e_rel_l2_head"] < 1e-3 and ck["dw_rel_l2_head"] < DW_F32_REL,
                f"bench_gsu_kernel: kernels E and dW {ck}")
        require(res["launches"] == res["calls"] and res["calls"]["E"] > 0,
                f"bench_gsu_kernel: launches {res['launches']}, calls {res['calls']}")

        # (d) the profiler trace of the flagship forward and train step
        res, lines = quiet_main(profile_trace.main, [
            "--serving", "--batch", PROF_B, "--seconds", PROF_SECONDS, "--trace-dir", work / "trace",
            "--summary", work / "summary.md"])
        summary = (work / "summary.md").read_text()
        out["d"] = {"launches": {}, "calls": {}, "top5": {}, "total_ms": {}}
        for name, want in (("forward", ("C",)), ("train_step", ("D", "E", "dW"))):
            prof = res["profiles"][name]
            json.loads(Path(prof["trace"]).read_text())  # the Chrome trace parses
            out["d"]["top5"][name] = prof["rows"][:5]
            out["d"]["total_ms"][name] = prof["total_ms"]
            for k in want:
                w = TOOL_KERNELS[k]
                calls = profile_trace.kernel_calls(prof["rows"], w)
                out["d"]["calls"][k], out["d"]["launches"][k] = calls, prof["launches"].get(w, 0)
                if k != "dW":  # dW's rows (a few ms) may fall below the table's top 25
                    require(profile_trace.KERNEL_ROWS[w] in summary,
                            f"profile_trace: the summary names no {profile_trace.KERNEL_ROWS[w]}")
            log(f"[tools] (d) profile_trace {name}: {prof['total_ms']:.3f} ms of kernels; "
                f"launches {prof['launches']}; top five "
                + "; ".join(f"{op[:70]} {ms:.3f} ms x{n}" for op, ms, n in prof["rows"][:5]))
        require(out["d"]["calls"] == out["d"]["launches"]
                and all(v > 0 for v in out["d"]["calls"].values()),
                f"profile_trace: kernel rows' calls {out['d']['calls']} against the wrappers' "
                f"launches {out['d']['launches']}")

        # (e) the N-DNS board on zoo M's weights, then calculate_metrics
        tree = board_tree(work / "ndns")
        zoo = load_npz(str(ZOO_M), device="cpu")
        ckpt = work / "pytorch_model.bin"
        torch.save(reference_state_dict(zoo["params"], zoo["state"]), ckpt)
        build = reproduce_board.build_config

        def zoo_m_config(size, dns_root, out_dir, limit=None):
            path = build(size, dns_root, out_dir, limit=limit)
            c = toml_load(path)
            c["model"]["args"].update(BOARD_ZOO_M)
            toml_dump(c, path)
            return path

        reproduce_board.build_config = zoo_m_config
        try:
            zero_counts(gk)
            t0 = time.perf_counter()
            rc, lines = quiet_main(reproduce_board.main, [
                "--dns_root", tree, "--size", "m", "--out", work / "board",
                "--torch_ckpt", ckpt, "--entry_name", "zoo_m_port"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = {k: v for k, v in launch_counts(gk).items() if v}
        finally:
            reproduce_board.build_config = build
        row = json.loads([ln for ln in lines if ln.startswith("{")][-1])
        toml = work / "board" / "board_m.toml"
        cli.main(["-C", str(toml), "-M", "predict", "--torch_ckpt", str(ckpt),
                  "--device", dev.type], recipe_dir=reproduce_board.RECIPE)
        enhanced = work / "board" / "board_m" / "enhanced" / "dataloader_0"
        means, _ = quiet_main(calculate_metrics.main, [
            "-E", enhanced, "-R", tree / "clean", "-O", work / "metrics.csv",
            "--num_workers", 1])
        out["e"] = {"rc": rc, "row": row, "seconds": secs, "launches": launches,
                    "calculate_metrics": means,
                    "pandas_installed": importlib.util.find_spec("pandas") is not None}
        log(f"[tools] (e) reproduce_board, zoo M weights, {BOARD_UTTS} x {BOARD_SECONDS:g} s in "
            f"{secs:.1f} s: SI-SNR {row['SI-SNR']}, SI-SNRi {row['SI-SNRi_data']}, power proxy "
            f"{row['power_proxy_Ops/s']} Ops/s, params {row['params']}, latency "
            f"{row['latency_total_ms']} ms; launches {launches}; calculate_metrics over the "
            f"predicted WAVs {means}; pandas installed: {out['e']['pandas_installed']}")
        require(rc == 0 and np.isfinite(row["SI-SNR"]) and row["latency_total_ms"] == 8.036,
                f"reproduce_board row {row}")
        require(row["params"] == ZOO_M_PARAMS and row["SI-SNR"] > 8.0,
                f"reproduce_board: the tested model {row}")
        require(launches == {"F": 4 * BOARD_UTTS}, f"reproduce_board launched {launches}")
        require(abs(means["si_sdr"] - row["SI-SNR"]) < 0.1,
                f"calculate_metrics {means} against the row's SI-SNR {row['SI-SNR']}")

        # (f) the model zoo's build from a reference-layout tree
        ref = write_reference_zoo(work / "ref", "m")
        zero_counts(gk)
        t0 = time.perf_counter()
        entries, lines = quiet_main(build_model_zoo.main, [
            "--sizes", "m", "--utts", ZOO_UTTS, "--ref-zoo", ref, "--out", work / "zoo"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: v for k, v in launch_counts(gk).items() if v}
        e = entries[0]
        out["f"] = {"entry": e, "seconds": secs, "launches": launches}
        log(f"[tools] (f) build_model_zoo --sizes m --utts {ZOO_UTTS} in {secs:.1f} s: SI-SNR "
            f"{e['SI-SNR']} dB (entries_framework.json {ZOO_M_SISNR}), params {e['params']}, "
            f"synops {e['PDP_proxy_Ops']}, launches {launches}")
        require(e["params"] == ZOO_M_PARAMS and abs(e["SI-SNR"] - ZOO_M_SISNR) <= ZOO_SISNR_TOL,
                f"build_model_zoo entry {e}")
        require(launches == {"F": 4 * ZOO_UTTS}, f"build_model_zoo launched {launches}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[tools] phase 17 on {smi}: {out['seconds']:.1f} s")
    return out


def add_tools_rows(kernels, rec):
    """Each kernel's launches in phase 17 beside its line: C in the
    roofline's forward and the profiled one, D, E and dW in the kernel
    bench and the profiled step, F in the board's test batches and the
    zoo's utterances."""
    names = {"sfsb_monolith_serve": "C", "gsu_layer_train_fwd": "D",
             "gsu_layer_train_bwd": "E", "gsu_train_dw": "dW", "gsu_stack_eval_x": "F"}
    for entry in kernels:
        k = names.get(entry["name"])
        if k == "C":
            entry["tools"] = {"roofline_forward": rec["b"]["c_launches"],
                              "profile_trace": rec["d"]["launches"]["C"]}
        elif k in ("D", "E", "dW"):
            entry["tools"] = {"bench_gsu_kernel": rec["c"]["launches"][k],
                              "profile_trace": rec["d"]["launches"][k]}
        elif k == "F":
            entry["tools"] = {"reproduce_board": rec["e"]["launches"].get("F", 0),
                              "build_model_zoo": rec["f"]["launches"].get("F", 0)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run", file=sys.stderr)
        return 2
    try:
        from spiking_fullsubnet_torch.models import cirm_models as cm
        from spiking_fullsubnet_torch.models import stream_forward as sf
        from spiking_fullsubnet_torch.models.presets import flagship_m
        from spiking_fullsubnet_torch.models.spiking_fullsubnet import (
            SpikingFullSubNet, separator_config, spiking_fullsubnet_apply)
        from spiking_fullsubnet_torch.ops import gsu_kernels as gk
        from spiking_fullsubnet_torch.recipes.denoise import adamw, train_step
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 2
    if not ZOO_M.exists():
        print(f"chip_smoke: missing {ZOO_M}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. card ----
    smi = card_name()
    log(f"[card] {smi}")
    log(f"[card] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"| CUDA {torch.version.cuda} | count {torch.cuda.device_count()}")

    # ---- 2. build ----
    stamp("2. build")
    secs_build = gk.build_kernels()
    log(f"[build] kernels built and loaded in {secs_build:.2f} s")
    for name, text in gk.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # ---- 3. kernels against their plain versions, main-path inputs ----
    stamp("3. kernels against their plain versions, main-path inputs")
    torch.set_grad_enabled(False)  # phases 3-5 are eval; SpikingFullSubNet's weights are trainable
    base = replace(separator_config(norm_type="offline_laplace_norm", shared_weights=True,
                                    bn=True), scan_mode="auto", collect_layer_outputs=False)
    model = SpikingFullSubNet.from_npz(str(ZOO_M), base, device=dev)
    flag_base = flagship_m(seed=0, device=dev, scan_mode="auto",
                           collect_layer_outputs=False)["config"]
    flag = SpikingFullSubNet.from_init(flag_base, seed=0, device=dev)
    # separator_config as it comes: scan_mode="layered", every layer collected
    lay_base = separator_config(norm_type="offline_laplace_norm", shared_weights=True, bn=True)
    cirm = cm.build(seed=0, device=dev, **CIRM_GSN)

    def cirm_forward(x, dt="bfloat16"):
        cfg = replace(cirm["config"], compute_dtype=dt)
        return cm.cirm_model_apply(cfg, cirm["params"], cirm["state"], x)

    rng = np.random.default_rng(0)
    bench = torch.from_numpy(
        (rng.standard_normal((BENCH_B, int(BENCH_SECONDS * SR))) * 0.1).astype(np.float32)).to(dev)
    clean, noisy = speech_fixture()
    quality_x = torch.from_numpy(noisy[None]).to(dev)
    checks = {"A": {}, "B": {}, "C": {}, "F": {}}
    plain_ms, spikes, captured_bf16 = {}, {}, {}
    for dt in (None, "bfloat16"):
        tag = dt or "float32"
        cfg = replace(base, compute_dtype=dt)
        # (a) the quality forward's own inputs (zoo M, 1 x 2 s), whole sequence
        seen = capture_kernel_args(sf, cfg, model, quality_x)
        (a_args, _), (b_args, _) = seen["A"], seen["B"]
        got_a, ref_a = gk.gsu_stack_eval(*a_args), gk.stack_eval_plain(*a_args)
        got_b, ref_b = gk.gsu_sections_eval(*b_args), gk.sections_eval_plain(*b_args)
        torch.cuda.synchronize()
        mism, rel = spike_mismatch(got_a, ref_a), rel_l2(got_b, ref_b)
        err_a, err_b = max_abs(got_a, ref_a), max_abs(got_b, ref_b)
        log(f"[kernels] {tag} 1 x 2 s {tuple(a_args[0].shape)}: A spike mismatch {mism:.3e}; "
            f"B rel L2 {rel:.3e}, max abs err {err_b:.3e}")
        require(mism < 1e-3, f"kernel A {tag}: spike mismatch {mism}")
        require(rel < 0.05, f"kernel B {tag}: rel L2 {rel}")
        checks["A"][tag] = {"spike_mismatch": mism, "max_abs_err": err_a}
        checks["B"][tag] = {"rel_l2": rel, "max_abs_err": err_b}

        # (b) the bench batch (256 x 30 s), first WINDOW frames. A's 4-D units
        # form and collect_all run the same per-row arithmetic as its 3-D
        # form, so they must reproduce it exactly.
        seen = capture_kernel_args(sf, cfg, model, bench)
        (a_args, _), (b_args, _) = seen["A"], seen["B"]
        xg0, *wa = a_args
        head = xg0[:WINDOW].contiguous()
        T, R, G = head.shape
        ref3 = gk.gsu_stack_eval(head, *wa)
        all3 = gk.gsu_stack_eval(head, *wa, collect_all=True)
        x4 = head.reshape(T, 4, R // 4, G).transpose(0, 1).contiguous()
        got4 = gk.gsu_stack_eval(x4, *wa).transpose(0, 1).reshape(T, R, -1)
        plain3 = gk.stack_eval_plain(head, *wa)
        bh = head_b(b_args, WINDOW)
        rel_h = rel_l2(gk.gsu_sections_eval(*bh), gk.sections_eval_plain(*bh))
        torch.cuda.synchronize()
        require(torch.equal(all3[-1], ref3), f"kernel A {tag}: collect_all != 3-D")
        require(torch.equal(got4, ref3), f"kernel A {tag}: 4-D form != 3-D")
        mism_h = spike_mismatch(ref3, plain3)
        log(f"[kernels] {tag} bench first {WINDOW} frames: A spike mismatch {mism_h:.3e}, "
            f"4-D {tuple(x4.shape)} and collect_all {tuple(all3.shape)} equal the 3-D form; "
            f"B rel L2 {rel_h:.3e}")
        require(mism_h < 1e-3, f"kernel A {tag} first {WINDOW} frames: {mism_h}")
        require(rel_h < 0.05, f"kernel B {tag} first {WINDOW} frames: {rel_h}")
        checks["A"][tag]["bench_head_spike_mismatch"] = mism_h
        checks["B"][tag]["bench_head_rel_l2"] = rel_h

        # (c) the whole bench sequence, kernel and plain version each against
        # a float64 run of the plain version (see the module docstring)
        got_a = gk.gsu_stack_eval(*a_args)
        ms_a, counts_a, ref_a = plain_run(gk.stack_eval_plain, a_args)
        ora_a = gk.stack_eval_plain(*as_f64_a(a_args))
        k_a, p_a = spike_mismatch(got_a, ora_a), spike_mismatch(ref_a, ora_a)
        kp_a = spike_mismatch(got_a, ref_a)
        del got_a, ref_a, ora_a
        got_b = gk.gsu_sections_eval(*b_args)
        ms_b, counts_b, ref_b = plain_run(gk.sections_eval_plain, b_args)
        ora_b = gk.sections_eval_plain(*as_f64_b(b_args))
        k_b, p_b, kp_b = rel_l2(got_b, ora_b), rel_l2(ref_b, ora_b), rel_l2(got_b, ref_b)
        del got_b, ref_b, ora_b
        log(f"[kernels] {tag} whole bench {tuple(a_args[0].shape)}, against float64: "
            f"A spike mismatch kernel {k_a:.3e}, plain {p_a:.3e} (kernel vs plain {kp_a:.3e}); "
            f"B rel L2 kernel {k_b:.3e}, plain {p_b:.3e} (kernel vs plain {kp_b:.3e})")
        require(k_a <= 3 * p_a + 1e-3, f"kernel A {tag}: drift {k_a} vs plain {p_a}")
        require(k_b <= 3 * p_b + 1e-3, f"kernel B {tag}: drift {k_b} vs plain {p_b}")
        checks["A"][tag].update(bench_drift_f64=k_a, plain_drift_f64=p_a, bench_vs_plain=kp_a)
        checks["B"][tag].update(bench_drift_f64=k_b, plain_drift_f64=p_b, bench_vs_plain=kp_b)
        if dt:
            captured_bf16.update(A=seen["A"], B=seen["B"])
            plain_ms.update(A=ms_a, B=ms_b)
            spikes.update(A=counts_a, B=counts_b)
        del seen, a_args, b_args, xg0, wa, bh
        torch.cuda.empty_cache()

        # kernel C on flagship M: (a) 1 x 2 s whole, (b) bench first WINDOW
        # steps, (c) the whole bench against float64
        cfg = replace(flag_base, compute_dtype=dt)
        (c_args, _) = capture_kernel_args(sf, cfg, flag, quality_x)["C"]
        got_c, ref_c = gk.sfsb_monolith_serve(*c_args), gk.monolith_serve_plain(*c_args)
        torch.cuda.synchronize()
        rel_c, err_c = rel_l2(got_c, ref_c), max_abs(got_c, ref_c)
        (c_args, _) = capture_kernel_args(sf, cfg, flag, bench)["C"]
        c_head = head_c(c_args, WINDOW)
        rel_ch = rel_l2(gk.sfsb_monolith_serve(*c_head), gk.monolith_serve_plain(*c_head))
        log(f"[kernels] {tag} flagship C 1 x 2 s {tuple(got_c.shape)}: rel L2 {rel_c:.3e}, "
            f"max abs err {err_c:.3e}; bench first {WINDOW} steps: rel L2 {rel_ch:.3e}")
        require(rel_c < 0.05, f"kernel C {tag}: rel L2 {rel_c}")
        require(rel_ch < 0.05, f"kernel C {tag} first {WINDOW} steps: {rel_ch}")
        got_c = gk.sfsb_monolith_serve(*c_args)
        ms_c, counts_c, ref_c = plain_run(gk.monolith_serve_plain, c_args)
        ora_c = gk.monolith_serve_plain(*as_f64_c(c_args))
        k_c, p_c, kp_c = rel_l2(got_c, ora_c), rel_l2(ref_c, ora_c), rel_l2(got_c, ref_c)
        del got_c, ref_c, ora_c
        log(f"[kernels] {tag} flagship C whole bench {tuple(c_args[1].shape)}, against "
            f"float64: rel L2 kernel {k_c:.3e}, plain {p_c:.3e} (kernel vs plain {kp_c:.3e})")
        require(k_c <= 3 * p_c + 1e-3, f"kernel C {tag}: drift {k_c} vs plain {p_c}")
        checks["C"][tag] = {"rel_l2": rel_c, "max_abs_err": err_c, "bench_head_rel_l2": rel_ch,
                            "bench_drift_f64": k_c, "plain_drift_f64": p_c,
                            "bench_vs_plain": kp_c}
        if dt:
            captured_bf16["C"] = (c_args, {})
            plain_ms["C"] = ms_c
            spikes["C"] = counts_c
        del c_args, c_head
        torch.cuda.empty_cache()

        # kernel F at each of its launches (STACKS_F): the four stacks of zoo
        # M's layered forward (fullband, three sections) and cIRM-GSN's one.
        # (a) 1 x 2 s whole, (b) bench first WINDOW frames, (c) the whole
        # bench sequence of each stack's first ROWS_F64 rows against float64
        lay = replace(lay_base, compute_dtype=dt)
        params, state = model.param_tree(), model.state_tree()

        def zoo_layered(x):
            return spiking_fullsubnet_apply(lay, params, state, x)

        f_q, f_b = [], []
        for x, into in ((quality_x, f_q), (bench, f_b)):
            zoo_f, cirm_f = capture_f_args(gk, zoo_layered, x), capture_f_args(
                gk, lambda v: cirm_forward(v, dt), x)
            require(len(zoo_f) == 4 and len(cirm_f) == 1,
                    f"kernel F {tag}: {len(zoo_f)} zoo-M and {len(cirm_f)} cIRM-GSN launches")
            into += zoo_f + cirm_f
        rec = {"stacks": list(STACKS_F), "spike_mismatch": [], "max_abs_err": 0.0,
               "bench_head_spike_mismatch": [], "bench_drift_f64": [], "plain_drift_f64": [],
               "bench_vs_plain": []}
        for args in f_q:
            got, ref = gk.gsu_stack_eval_x(*args), gk.stack_eval_x_plain(*args)
            torch.cuda.synchronize()
            rec["spike_mismatch"].append(spike_mismatch(got, ref))
            rec["max_abs_err"] = max(rec["max_abs_err"], max_abs(got, ref))
        for args in f_b:
            head = (args[0][:WINDOW].contiguous(), *args[1:])
            rec["bench_head_spike_mismatch"].append(spike_mismatch(
                gk.gsu_stack_eval_x(*head), gk.stack_eval_x_plain(*head)))
            sub = (args[0][:, :ROWS_F64].contiguous(), *args[1:])
            got, ref = gk.gsu_stack_eval_x(*sub), gk.stack_eval_x_plain(*sub)
            ora = gk.stack_eval_x_plain(*as_f64_f(sub))
            rec["bench_drift_f64"].append(spike_mismatch(got, ora))
            rec["plain_drift_f64"].append(spike_mismatch(ref, ora))
            rec["bench_vs_plain"].append(spike_mismatch(got, ref))
            del got, ref, ora
        fmt = lambda v: "[" + ", ".join(f"{x:.3e}" for x in v) + "]"  # noqa: E731
        log(f"[kernels] {tag} F at {list(STACKS_F)}, 1 x 2 s {[tuple(a[0].shape) for a in f_q]}: "
            f"spike mismatch {fmt(rec['spike_mismatch'])}, max abs err {rec['max_abs_err']:.3e}; "
            f"bench first {WINDOW} frames {fmt(rec['bench_head_spike_mismatch'])}")
        log(f"[kernels] {tag} F whole bench, first {ROWS_F64} rows of "
            f"{[tuple(a[0].shape) for a in f_b]}, against float64: kernel "
            f"{fmt(rec['bench_drift_f64'])}, plain {fmt(rec['plain_drift_f64'])} "
            f"(kernel vs plain {fmt(rec['bench_vs_plain'])})")
        for i, stack in enumerate(STACKS_F):
            require(rec["spike_mismatch"][i] < 1e-3, f"kernel F {tag} {stack}: {rec}")
            require(rec["bench_head_spike_mismatch"][i] < 1e-3,
                    f"kernel F {tag} {stack} first {WINDOW} frames: {rec}")
            require(rec["bench_drift_f64"][i] <= 3 * rec["plain_drift_f64"][i] + 1e-3,
                    f"kernel F {tag} {stack}: drift {rec}")
        checks["F"][tag] = rec
        if dt:
            counts_f, ms_f = [], []
            for args in f_b:
                counts_f.append([])
                ms_f.append(cuda_ms(lambda: gk.stack_eval_x_plain(
                    *args, spike_counts=counts_f[-1]), warmup=0))
            log(f"[kernels] plain F at the bench stacks {list(STACKS_F)}: {fmt(ms_f)} ms")
            captured_bf16["F"] = f_b
            plain_ms["F"] = ms_f
            spikes["F"] = counts_f
        del f_q, f_b, params, state
        torch.cuda.empty_cache()

    # ---- 4. quality: the main paths, each counted ----
    stamp("4. quality: the main paths, each counted")
    def counted(m, x):
        return counted_run(gk, lambda: m(x))

    def gain_of(out):
        return si_sdr_gain(out["enhanced_y"], clean, noisy)

    model.cfg = replace(base, compute_dtype="bfloat16")
    out, launches = counted(model, quality_x)
    gain = gain_of(out)
    log(f"[quality] zoo M offline norm bf16 1 x 2 s: SI-SDR gain {gain:.3f} dB, "
        f"launches {launches}")
    require(gain > 8.0, f"SI-SDR gain {gain} dB")
    require(launches == {"A": 1, "B": 1, "C": 0, "F": 0}, f"launches {launches}")

    cum_cfg = replace(separator_config(norm_type="cumulative_laplace_norm", shared_weights=True,
                                       bn=True), scan_mode="auto", collect_layer_outputs=False,
                      compute_dtype="bfloat16")
    cum_model = SpikingFullSubNet.from_npz(str(ZOO_M), cum_cfg, device=dev)
    out, cum_launches = counted(cum_model, quality_x)
    cum_gain = gain_of(out)
    log(f"[quality] zoo M cumulative norm bf16 1 x 2 s (monolith): SI-SDR gain "
        f"{cum_gain:.3f} dB, launches {cum_launches}")
    require(cum_gain > 8.0, f"cumulative-norm SI-SDR gain {cum_gain} dB")
    require(cum_launches == {"A": 0, "B": 0, "C": 1, "F": 0}, f"launches {cum_launches}")
    del cum_model

    flag.cfg = replace(flag_base, compute_dtype="bfloat16")
    out, flag_launches = counted(flag, quality_x)
    y = out["enhanced_y"]
    require(tuple(y.shape) == tuple(quality_x.shape) and bool(torch.isfinite(y).all()),
            "flagship M: enhanced audio shape/finite")
    log(f"[quality] flagship M bf16 1 x 2 s (monolith): {tuple(y.shape)} finite, "
        f"rms {y.float().square().mean().sqrt().item():.4f}, launches {flag_launches}")
    require(flag_launches == {"A": 0, "B": 0, "C": 1, "F": 0}, f"launches {flag_launches}")
    launches["C"] = flag_launches["C"]

    layered = SpikingFullSubNet.from_npz(str(ZOO_M), replace(lay_base, compute_dtype="bfloat16"),
                                         device=dev)
    out, lay_launches = counted(layered, quality_x)
    lay_gain = gain_of(out)
    n_sb = [len(s) for s in out["sb_all_layer_outputs"]]
    log(f"[quality] zoo M layered bf16 1 x 2 s: SI-SDR gain {lay_gain:.3f} dB, launches "
        f"{lay_launches}, collected outputs fb {len(out['fb_all_layer_outputs'])}, sb {n_sb}")
    require(lay_gain > 8.0, f"layered SI-SDR gain {lay_gain} dB")
    require(lay_launches == {"A": 0, "B": 0, "C": 0, "F": 4}, f"launches {lay_launches}")
    require(len(out["fb_all_layer_outputs"]) == 4 and n_sb == [4, 4, 4],
            "layered: every layer's outputs collected")
    launches["F"] = lay_launches["F"]

    out, cirm_launches = counted(cirm_forward, quality_x)
    y = out["enhanced_y"]
    require(tuple(y.shape) == tuple(quality_x.shape) and bool(torch.isfinite(y).all()),
            "cIRM-GSN: enhanced audio shape/finite")
    log(f"[quality] cIRM-GSN bf16 1 x 2 s (random weights): {tuple(y.shape)} finite, "
        f"rms {y.float().square().mean().sqrt().item():.4f}, launches {cirm_launches}")
    require(cirm_launches == {"A": 0, "B": 0, "C": 0, "F": 1}, f"launches {cirm_launches}")
    launches["F cIRM-GSN"] = cirm_launches["F"]

    # ---- 5. timing ----
    stamp("5. timing")
    forwards = {}
    for name, m in (("zoo M", model), ("flagship M", flag), ("zoo M layered", layered),
                    ("cIRM-GSN", cirm_forward)):
        # the script still holds the captured kernel inputs and the models:
        # peak_gb - held_gb is the forward's own
        held_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        fwd_ms = cuda_ms(lambda: m(bench)["enhanced_y"], iters=2)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        forwards[name] = {"ms": fwd_ms, "audio_s_per_s": BENCH_B * BENCH_SECONDS / fwd_ms * 1e3,
                          "peak_gb": peak_gb, "held_gb": held_gb}
        log(f"[timing] forward {name} bf16 {BENCH_B} x {BENCH_SECONDS:g} s: {fwd_ms:.3f} ms "
            f"({forwards[name]['audio_s_per_s']:.1f} audio-s/s), peak memory {peak_gb:.2f} GB "
            f"of which {held_gb:.2f} GB held before the forward")
        torch.cuda.empty_cache()
    kernels = []
    specs = {
        "A": ("gsu_stack_eval", gk.gsu_stack_eval, "spiking_fullsubnet_torch/csrc/gsu_stack_eval.cu",
              "spiking_fullsubnet_tpu/ops/gsu_pallas.py:923", bound_a),
        "B": ("gsu_sections_eval", gk.gsu_sections_eval,
              "spiking_fullsubnet_torch/csrc/gsu_sections_eval.cu",
              "spiking_fullsubnet_tpu/ops/gsu_pallas.py:1174", bound_b),
        "C": ("sfsb_monolith_serve", gk.sfsb_monolith_serve,
              "spiking_fullsubnet_torch/csrc/sfsb_monolith_serve.cu",
              "spiking_fullsubnet_tpu/ops/gsu_pallas.py:1626", bound_c),
    }
    for key, (name, fn, src, replaces, bound) in specs.items():
        args, kw = captured_bf16[key]
        ms = cuda_ms(lambda: fn(*args, **kw), iters=3)
        nbytes, ops, ops_s = bound(args, spikes[key])
        b_bytes, b_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops_s * 1e3
        shape = {"A": lambda: args[0].shape, "B": lambda: args[1].shape,
                 "C": lambda: args[1].shape}[key]()
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[key], "max_abs_err": checks[key]["bfloat16"]["max_abs_err"],
            "ms": ms, "plain_ms": plain_ms[key], "bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "library_ms": None, "bytes": nbytes, "ops": ops, "spikes": spikes[key],
            "shape": list(shape), "checks": checks[key],
        })
        log(f"[timing] {name}: {ms:.3f} ms, plain {plain_ms[key]:.1f} ms, bound "
            f"{max(b_bytes, b_ops):.4f} ms ({kernels[-1]['bound_by']}; bytes {b_bytes:.4f} ms, "
            f"operations {b_ops:.4f} ms)")
        if key == "A":
            kernels[-1].update(a_extras(gk, args, kw))
        if key == "B":
            kernels[-1].update(b_extras(gk, args))
        if key == "C":
            # the plan: rows per tile, blocks per cluster, the clusters the
            # card holds at once and the waves; half the batch is half the
            # clusters, so with one wave the two times are about equal
            occ = gk.monolith_occupancy(*args)
            kernels[-1]["plan"] = occ
            log(f"[timing] {name} plan: {occ['rows_per_tile']} rows a tile, "
                f"{occ['blocks_per_cluster']} blocks a cluster (shared memory {occ['smem']} "
                f"bytes; unit blocks (section, first unit, units) {occ['units']}), "
                f"{occ['clusters']} clusters, {occ['in_flight']} in flight (the card holds "
                f"{occ['max_active_clusters']}), {occ['waves']} wave(s)")
            # the weights are packed at a spec's first launch (not timed
            # above); the serving forward builds its spec anew, so it pays this
            kernels[-1]["pack_ms"] = cuda_ms(lambda: gk.monolith_pack(args[0], torch.bfloat16),
                                             iters=2)
            log(f"[timing] {name} weight packing (monolith_pack): "
                f"{kernels[-1]['pack_ms']:.3f} ms")
            require(occ["waves"] == 1, f"kernel C: {occ['waves']} waves at batch {BENCH_B}")
            half = (args[0], args[1][:, :BENCH_B // 2].contiguous())
            kernels[-1]["half_batch_ms"] = cuda_ms(lambda: fn(*half), iters=2)
            log(f"[timing] {name} at batch {BENCH_B // 2}: {kernels[-1]['half_batch_ms']:.3f} ms")
            first, again = fn(*args), fn(*args)
            torch.cuda.synchronize()
            require(torch.equal(first, again), "kernel C: two launches on the bench's inputs differ")
            kernels[-1]["checks"]["bitwise_twice"] = True
            del first, again
            # SM cycles a step in each stage's phases (one profiled launch);
            # the slowest block sets the pace, the others wait at the barrier
            prof = gk.monolith_profile(*args)
            kernels[-1]["stage_cycles_per_step"] = prof
            for role in ("io", "fullband", "units"):
                log(f"[timing] {name} {role} block, SM cycles a step: " + ", ".join(
                    f"{ph} {v:.0f}" for ph, v in prof[role].items()))
            log(f"[timing] {name} unit blocks' busy cycles a step: "
                + ", ".join(f"{v:.0f}" for v in prof["units_busy_each"]))
    kernels.append(kernel_f_entry(gk, captured_bf16["F"], plain_ms["F"], spikes["F"],
                                  launches, checks["F"], forwards))
    del captured_bf16, bench
    torch.cuda.empty_cache()

    # ---- 6. training ----
    stamp("6. training")
    torch.set_grad_enabled(True)
    confs = {"zoo M": (spiking_fullsubnet_apply, lay_base, model.param_tree(), model.state_tree()),
             "cIRM-GSN": (cm.cirm_model_apply, cirm["config"], cirm["params"], cirm["state"])}
    fix_noisy, fix_clean, tb_noisy, tb_clean = training_batches(dev)

    # (a) D and E against their plain versions on the arguments of one f32
    # forward and backward: the fixture batch and the training batch
    d_q, e_q, d_b, e_b = [], [], [], []
    for name, (apply, cfg, p, st) in confs.items():
        for x, ref_y, d_into, e_into in ((fix_noisy, fix_clean, d_q, e_q),
                                         (tb_noisy, tb_clean, d_b, e_b)):
            d, e = capture_de_args(gk, lambda: fwd_bwd(apply, cfg, fresh(p), st, x, ref_y))
            require(len(d) == len(e) == (8 if name == "zoo M" else 2),
                    f"{name}: {len(d)} launches of D and {len(e)} of E")
            d_into += d
            e_into += e
    trec = {"D": {"fixture": d_checks(gk, d_q), "training_batch": d_checks(gk, d_b)},
            "E": {"fixture": e_checks(gk, e_q), "training_batch_head": e_checks(gk, e_b, WINDOW)}}
    trec["D"]["max_abs_err"] = max(max(trec["D"][tag]["step_y_err"])
                                   for tag in ("fixture", "training_batch"))
    trec["E"]["max_abs_err"] = trec["E"]["fixture"]["max_abs_err"]
    trec["dW"] = {"rel_l2": trec["E"]["fixture"]["dw_rel_l2"],
                  "max_abs_err": trec["E"]["fixture"]["dw_max_abs_err"]}
    d_plain_ms = trec["D"]["training_batch"]["plain_ms"]
    e_plain_ms = [cuda_ms(lambda: gk.layer_train_bwd_plain(*ea), warmup=0) for ea in e_b]
    fmt = lambda v: "[" + ", ".join("-" if x is None else f"{x:.3e}" for x in v) + "]"  # noqa: E731
    log(f"[training] D and E at {list(LAYERS_DE)}")
    for tag, shape in (("fixture", tuple(fix_noisy.shape)), ("training_batch", tuple(tb_noisy.shape))):
        r = trec["D"][tag]
        log(f"[training] D {tag} {shape}: spike mismatch {fmt(r['spike_mismatch'])}; first "
            f"differing step {r['first_diff_step']}; each step against one float64 step from "
            f"its own y[t-1]: membranes max abs err kernel {fmt(r['step_y_err'])}, plain "
            f"{fmt(r['plain_step_y_err'])}; statistics kernel {fmt(r['step_stats_err'])}, "
            f"plain {fmt(r['plain_step_stats_err'])}; kernel spikes of the other sign "
            f"{r['step_flips']} with step |y| <= {fmt(r['step_flip_max_abs_y'])}; against a "
            f"float64 run: {onset_text(r)}, spike drift kernel {fmt(r['drift_f64'])} (mean "
            f"{np.mean(r['drift_f64']):.3e}), plain {fmt(r['plain_drift_f64'])} (mean "
            f"{np.mean(r['plain_drift_f64']):.3e})")
    log(f"[training] E fixture whole sequence rel L2 {fmt(trec['E']['fixture']['rel_l2'])}; "
        f"training batch first {WINDOW} frames {fmt(trec['E']['training_batch_head']['rel_l2'])}; "
        f"dW rel L2 {fmt(trec['dW']['rel_l2'])}")
    log(f"[training] plain D {fmt(d_plain_ms)} ms, plain E {fmt(e_plain_ms)} ms")
    # the batch statistics couple every row, so one rounding flip (a membrane
    # within rounding of the threshold, every few dozen steps at these sizes)
    # moves the whole layer onto another trajectory. Every step of every
    # layer is therefore held against one float64 step from the layer's own
    # previous membranes, to the plain f32 version's rounding, and a spike of
    # the other sign must sit at the threshold. Against a float64 run, each
    # layer's membranes are held up to and with the step where its spikes
    # part from that run's. A layer's drift after it is one draw of that
    # chaos, not an average over independent rows as for F: it is logged
    # (check_d).
    for tag in ("fixture", "training_batch"):
        check_d(tag, trec["D"][tag], LAYERS_DE)
    for layer, rel, head, w in zip(LAYERS_DE, trec["E"]["fixture"]["rel_l2"],
                                   trec["E"]["training_batch_head"]["rel_l2"],
                                   trec["dW"]["rel_l2"]):
        require(rel < 1e-3 and head < 1e-3, f"kernel E {layer}: {trec['E']}")
        require(w < DW_F32_REL, f"dW kernel {layer}: {trec['dW']}")

    # (b) five steps on the fixture batch, each counted; (c) one step's
    # gradients through E against E's plain version
    all_counters = {**COUNTERS, **TRAIN_WRAPPERS}
    grad_rel = {}
    for name, (apply, cfg, p, st0) in confs.items():
        params = fresh(p)
        opt = adamw(tensors_of(params))
        st, losses, counts = st0, [], []
        for _ in range(5):
            for wrapper in all_counters.values():
                getattr(gk, wrapper).launches = 0
            ld, st, norm = train_step(apply, cfg, params, st, fix_noisy, fix_clean, opt)
            torch.cuda.synchronize()
            counts.append({k: getattr(gk, w).launches for k, w in all_counters.items()})
            require(all(bool(torch.isfinite(v)) for v in ld.values())
                    and bool(torch.isfinite(norm)), f"{name}: non-finite loss or norm {ld}")
            require(all(bool(torch.isfinite(t.grad).all()) for t in tensors_of(params)),
                    f"{name}: non-finite gradient")
            losses.append(ld["loss"].item())
        want = train_launches(8 if name == "zoo M" else 2)
        moved = [not torch.equal(a, b) for a, b in zip(tensors_of(st), tensors_of(st0))]
        log(f"[training] {name} five steps on the fixture: losses {fmt(losses)}, launches per "
            f"step {counts[0]}, BN running statistics moved in {sum(moved)} of {len(moved)}")
        require(all(c == want for c in counts), f"{name}: launches {counts}")
        require(all(moved), f"{name}: BN running statistics did not move")
        if name == "cIRM-GSN":
            require(losses[-1] < losses[0], f"cIRM-GSN: loss {losses}")

        # one step's gradients through the kernels against the same step with
        # E (and so dW) swapped for E's plain version: the whole step is
        # deterministic on the card (D and E sum without atomics, and the
        # loss's STFT does not use torch.stft's reflect padding, whose
        # gradient is summed with atomic adds; train_witness.py shows two
        # steps bitwise equal), so both runs see the same forward and the
        # same gradient into the last layer, and E is held alone; D is held
        # step by step in (a)
        grad_rel[name] = g = grads_vs_plain_e(gk, apply, cfg, p, st0, fix_noisy, fix_clean)
        log(f"[training] {name} one step through the kernels against E's plain version on the "
            f"same forward (losses equal: {g['losses_equal']}): largest gradient-leaf rel L2 "
            f"{g['vs_plain_backward']:.3e} over {g['leaves']} leaves")
        require(g["vs_plain_backward"] < 1e-2, f"{name}: gradients {g}")
        del params, opt

    # (d) the train step at the training shape, bf16, and the kernels alone
    train_t = {}
    for name, (apply, cfg, p, st0) in confs.items():
        train_t[name] = t = time_train(apply, replace(cfg, compute_dtype="bfloat16"), p, st0,
                                       tb_noisy, tb_clean,
                                       train_launches(8 if name == "zoo M" else 2))
        t["grads_vs_plain"] = grad_rel[name]
        log(f"[timing] train step {name} bf16 {TRAIN_B} x {TRAIN_SECONDS:g} s: forward "
            f"{t['forward_ms']:.3f} ms, backward {t['backward_ms']:.3f} ms, clip and AdamW "
            f"{t['step_ms']:.3f} ms, total {t['total_ms']:.3f} ms ({t['audio_s_per_s']:.1f} "
            f"audio-s/s), own peak memory {t['own_peak_gb']:.2f} GB ({t['held_gb']:.2f} GB held "
            f"before), launches {t['launches']}; losses {t['losses']}, gradient norms "
            f"{t['grad_norms']}, non-finite steps {t['nonfinite_steps']}")
        torch.cuda.empty_cache()
    per = time_de_layers(gk, LAYERS_DE, d_b, e_b, d_plain_ms, e_plain_ms)
    kernels += de_entries({k: v[:8] for k, v in per.items()}, trec, train_t["zoo M"]["launches"],
                          beside={"cirm_gsn": ({k: v[8:] for k, v in per.items()},
                                               train_t["cIRM-GSN"]["launches"])})
    del d_b, e_b, d_q, e_q, per
    torch.cuda.empty_cache()

    # ---- 7. training on the stream path, bf16 streams ----
    stamp("7. training on the stream path, bf16 streams")
    stream = stream_phase(gk, spiking_fullsubnet_apply, flag, flag_base, model, base,
                          fix_noisy, fix_clean, tb_noisy, tb_clean, dev)
    kernels += stream.pop("kernels")
    train_t.update(stream.pop("training"))

    # ---- 8. serving in every mode: kernel B's modes, B against C, the collect path ----
    stamp("8. serving in every mode")
    torch.set_grad_enabled(False)
    modes = modes_phase(gk, sf, model, flag, flag_base, base, quality_x, clean, noisy, dev)
    kernels += modes.pop("kernels")
    forwards.update(modes.pop("forwards"))
    del model, flag
    torch.cuda.empty_cache()

    # ---- 9. the recipe trainer through its CLI ----
    stamp("9. the recipe trainer")
    trainer = trainer_phase(dev)

    # ---- 10. the flagship recipes: the fused forward and the GAN trainers ----
    stamp("10. the flagship recipes")
    flagship = {"fused": fused_forward_checks(gk, dev), "gan": gan_phase(gk, dev)}

    # ---- 11. serving: streaming, export, checkpoint import ----
    stamp("11. serving: streaming, export, checkpoint import")
    serving = serving_phase(gk, dev)

    # ---- 12. separation and dereverberation ----
    stamp("12. separation and dereverberation")
    separation = separation_phase(gk, dev)

    # ---- 13. the remaining models ----
    stamp("13. remaining models")
    remaining = remaining_models_phase(gk, dev)
    add_shared_subband_rows(kernels, remaining["shared_subband"])

    # ---- 14. data-parallel training ----
    stamp("14. data-parallel training")
    distributed = distributed_phase(gk, dev)
    add_distributed_rows(kernels, distributed)

    # ---- 15. the rest of the surface: tracer, modules, native reader ----
    stamp("15. the rest of the surface")
    surface = surface_phase(gk, dev)
    add_surface_rows(kernels, surface)

    # ---- 16. band-parallel sub-bands ----
    stamp("16. band-parallel sub-bands")
    band = band_phase(gk, dev)
    add_band_rows(kernels, band)

    # ---- 17. the tools ----
    stamp("17. the tools")
    tools = tools_phase(gk, dev)
    add_tools_rows(kernels, tools)
    stamp("end")
    print(json.dumps({"kernels": kernels, "forwards": forwards, "training": train_t,
                      "trainer": trainer, "flagship": flagship, "serving": serving,
                      "separation": separation, "remaining": remaining,
                      "distributed": distributed, "surface": surface, "band": band,
                      "tools": tools,
                      "stream_checks": stream, "mode_checks": modes["checks"],
                      "batch": BENCH_B, "seconds": BENCH_SECONDS,
                      "train_batch": TRAIN_B, "train_seconds": TRAIN_SECONDS}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-rank"]:
        dist_rank_main(*sys.argv[2:5])
        sys.exit(0)
    if sys.argv[1:2] == ["--band-rank"]:
        band_rank_main(*sys.argv[2:7])
        sys.exit(0)
    sys.exit(main())
