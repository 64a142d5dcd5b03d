"""The port's `.vxa` reader (`evosoro_tpu_torch.io.vxa`) held against the
JAX package's, field for field: the four designs an evosoro run archived in
`basic_data/bestSoFar/fitOnly/`, and a hand-written file with boundary
conditions of every primitive (the current `Boundary_Conditions` block and
the legacy fixed/forced blocks), an MDL_DATA material, DITHER and INTERNAL
palette entries, ZLIB-, BASE64- and ASCII-encoded layers, per-voxel
arrays, sources and the dormant neural-net block. Also `apply_bc_regions`,
`read_fitness_xml`, and `VXADocument.build_body` through `convert`."""

import base64
import dataclasses
import glob
import os
import zlib

import jax
import numpy as np
import pytest
import torch

from evosoro_tpu.io import vxa as jvxa
from evosoro_tpu_torch import convert
from evosoro_tpu_torch.io import vxa as pvxa

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = sorted(glob.glob(os.path.join(REPO, "basic_data", "bestSoFar", "fitOnly", "*.vxa")))


def _layers(a, enc):
    out = []
    for z in range(a.shape[2]):
        flat = a[:, :, z].T.reshape(-1).astype(np.uint8)
        if enc == "ASCII_READABLE":
            data = (flat + 48).tobytes().decode("latin-1")
        elif enc == "ZLIB":
            data = base64.b64encode(zlib.compress(flat.tobytes())).decode()
        else:
            data = base64.b64encode(flat.tobytes()).decode()
        out.append(f"<Layer><![CDATA[{data}]]></Layer>")
    return "\n".join(out)


def _float_layers(a):
    return "\n".join("<Layer><![CDATA[" + ", ".join(repr(float(v)) for v in a[:, :, z].T.ravel())
                     + "]]></Layer>" for z in range(a.shape[2]))


def _hand_written(path, enc):
    rng = np.random.default_rng(3)
    X, Y, Z = 5, 4, 3
    structure = rng.integers(0, 7, size=(X, Y, Z))
    sub = rng.integers(1, 3, size=(2, 2, 2))
    phase = np.round(rng.uniform(-1, 1, size=(X, Y, Z)), 6)
    xml = f"""<?xml version="1.0" encoding="ISO-8859-1"?>
<VXA Version="1.0">
<Simulator>
<Integration><DtFrac>0.7</DtFrac></Integration>
<Damping><BondDampingZ>0.8</BondDampingZ><ColDampingZ>0.6</ColDampingZ>
<SlowDampingZ>0.02</SlowDampingZ></Damping>
<Collisions><SelfColEnabled>1</SelfColEnabled><CollisionHorizon>3.0</CollisionHorizon></Collisions>
<Features><MaxVelLimitEnabled>1</MaxVelLimitEnabled><MaxVoxVelLimit>0.2</MaxVoxVelLimit>
<VolumeEffectsEnabled>0</VolumeEffectsEnabled></Features>
<StopCondition><StopConditionType>5</StopConditionType><StopConditionValue>0.3</StopConditionValue>
<InitCmTime>0.1</InitCmTime><AfterlifeTime>0.2</AfterlifeTime></StopCondition>
<EquilibriumMode><EquilibriumModeEnabled>1</EquilibriumModeEnabled></EquilibriumMode>
<GA><WriteFitnessFile>1</WriteFitnessFile><FitnessFileName>fit.xml</FitnessFileName></GA>
<MinTempFact>0.2</MinTempFact>
</Simulator>
<Environment>
<Boundary_Conditions><NumBCs>3</NumBCs>
<FRegion><PrimType>0</PrimType><X>0</X><Y>0</Y><Z>0</Z><dX>0.2</dX><dY>1</dY><dZ>1</dZ>
<DofFixed>63</DofFixed><DisplaceX>0.001</DisplaceX><AngDisplaceZ>0.1</AngDisplaceZ></FRegion>
<FRegion><PrimType>1</PrimType><X>0.5</X><Y>0.5</Y><Z>0</Z><dZ>1</dZ><Radius>0.3</Radius>
<DofFixed>4</DofFixed><ForceZ>-2.5</ForceZ><TorqueX>0.1</TorqueX></FRegion>
<FRegion><PrimType>2</PrimType><X>1</X><Y>1</Y><Z>1</Z><Radius>0.4</Radius>
<DofFixed>0</DofFixed><ForceX>1.0</ForceX><ForceY>0.5</ForceY></FRegion>
</Boundary_Conditions>
<Fixed_Regions><NumFixed>1</NumFixed>
<FRegion><PrimType>0</PrimType><X>0</X><Y>0.75</Y><Z>0</Z><dX>1</dX><dY>0.25</dY><dZ>0.3</dZ>
<Fixed>1</Fixed></FRegion></Fixed_Regions>
<Forced_Regions><NumForced>1</NumForced>
<FRegion><PrimType>0</PrimType><X>0.4</X><Y>0</Y><Z>0.6</Z><dX>0.2</dX><dY>1</dY><dZ>0.4</dZ>
<ForceY>-1.0</ForceY></FRegion></Forced_Regions>
<Gravity><GravEnabled>1</GravEnabled><GravAcc>-9.0</GravAcc><FloorEnabled>1</FloorEnabled></Gravity>
<Thermal><TempEnabled>1</TempEnabled><TempAmplitude>20</TempAmplitude><TempBase>25</TempBase>
<VaryTempEnabled>1</VaryTempEnabled><TempPeriod>0.2</TempPeriod></Thermal>
<NumTimeStepsInWindow>4</NumTimeStepsInWindow><TimeBetweenTraces>0.02</TimeBetweenTraces>
<NormDistByVol>1</NormDistByVol><FallingProhibited>1</FallingProhibited>
<Sources><Source><SourceType>0</SourceType><SourceEnabled>1</SourceEnabled>
<SourcePositionX>0.1</SourcePositionX><SourceMotionAmpY>0.02</SourceMotionAmpY>
<SourceMotionFreqY>0.5</SourceMotionFreqY></Source></Sources>
<NeuralNet><NumHiddenLayers>2</NumHiddenLayers><TouchSensorsEnabled>1</TouchSensorsEnabled>
</NeuralNet>
</Environment>
<VXC Version="0.93">
<Lattice><Lattice_Dim>0.005</Lattice_Dim></Lattice>
<Palette>
<Material ID="1"><Name>Soft</Name><Mechanical><MatModel>0</MatModel>
<Elastic_Mod>5e6</Elastic_Mod><Density>1e6</Density><CTE>0.01</CTE></Mechanical></Material>
<Material ID="2"><Name>Data</Name><Mechanical><MatModel>3</MatModel>
<SSData><NumDataPts>4</NumDataPts>
<StrainData><Strain>0</Strain><Strain>0.01</Strain><Strain>0.03</Strain><Strain>0.08</Strain>
</StrainData>
<StressData><Stress>0</Stress><Stress>40000</Stress><Stress>90000</Stress><Stress>120000</Stress>
</StressData></SSData><Density>1e6</Density></Mechanical></Material>
<Material ID="3"><Name>Bilinear</Name><Mechanical><MatModel>2</MatModel><Elastic_Mod>5e6</Elastic_Mod>
<Plastic_Mod>5e5</Plastic_Mod><Yield_Stress>1e5</Yield_Stress><CTE>-0.01</CTE></Mechanical></Material>
<Material ID="4"><MatType>3</MatType><Name>Dither</Name><RandIndex1>1</RandIndex1>
<RandIndex2>3</RandIndex2><PercIndex1>0.4</PercIndex1></Material>
<Material ID="5"><Name>Internal</Name><X_Offset>1</X_Offset><StructRotateAxis>2</StructRotateAxis>
<StructRotateAmount>1</StructRotateAmount>
<Structure Compression="ASCII_READABLE"><X_Voxels>2</X_Voxels><Y_Voxels>2</Y_Voxels>
<Z_Voxels>2</Z_Voxels><Data>
{_layers(sub, "ASCII_READABLE")}
</Data></Structure></Material>
<Material ID="6"><Name>Hard</Name><Mechanical><Elastic_Mod>5e8</Elastic_Mod></Mechanical>
<TempPhase>0.25</TempPhase></Material>
</Palette>
<Structure Compression="{enc}">
<X_Voxels>{X}</X_Voxels><Y_Voxels>{Y}</Y_Voxels><Z_Voxels>{Z}</Z_Voxels>
<Data>
{_layers(structure, enc)}
</Data>
<PhaseOffset>
{_float_layers(phase)}
</PhaseOffset>
</Structure>
</VXC>
</VXA>
"""
    with open(path, "w") as f:
        f.write(xml)
    return path


def _same(a, b, where):
    """Field-for-field equality of a JAX-package value and the port's."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            if f.name == "sources" and getattr(a, f.name) is not None:
                sa, sb = getattr(a, f.name), getattr(b, f.name)
                for k in ("base_pos", "amp", "freq", "enabled", "source_type"):
                    np.testing.assert_array_equal(np.asarray(getattr(sa, k)),
                                                  np.asarray(getattr(sb, k)), err_msg=k)
                continue
            _same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=where)
    else:
        assert a == b, (where, a, b)


@pytest.mark.parametrize("path", FIXTURES, ids=[p.split("--")[-1][:-4] for p in FIXTURES])
def test_fixtures_read_field_for_field(path):
    assert len(FIXTURES) == 4
    jd, pd = jvxa.load_vxa(path), pvxa.load_vxa(path)
    _same(jd, pd, "doc")
    assert pd.sim.self_collisions_enabled and pd.stop_condition_type == pvxa.SC_MAX_SIM_TIME
    assert pd.env.vary_temp_enabled and pd.structure.shape == (6, 6, 6)


@pytest.mark.parametrize("enc", ["ZLIB", "BASE64", "ASCII_READABLE"])
def test_hand_written_file_reads_field_for_field(tmp_path, enc):
    path = _hand_written(str(tmp_path / "hand.vxa"), enc)
    jd, pd = jvxa.load_vxa(path), pvxa.load_vxa(path)
    _same(jd, pd, "doc")
    # what the file sets came through (spot checks beside the equality)
    assert len(pd.bcs) == 5 and {b.prim_type for b in pd.bcs} == {0, 1, 2}
    assert pd.materials[1].mat_model == 3 and len(pd.materials[1].ss_strain) == 4
    assert pd.materials[3].mat_type == 3 and pd.materials[4].mat_type == 1
    assert not np.isin(pd.structure, (4, 5)).any()  # compound entries resolved
    assert pd.sim.equilibrium_mode and pd.sim.max_velocity_enabled
    assert pd.stop_condition_type == 5 and pd.env.neural_net.num_hidden_layers == 2
    assert "PhaseOffset" in pd.voxel_arrays
    for got, want in zip(pvxa.apply_bc_regions(pd.bcs, pd.structure, pd.lattice_dim),
                         jvxa.apply_bc_regions(jd.bcs, jd.structure, jd.lattice_dim)):
        np.testing.assert_array_equal(got, want)


def test_build_body_through_convert(tmp_path):
    """The port's `build_body` of a document equals the JAX package's body
    carried across with `convert`: BC arrays, MDL_DATA tables, material
    fields. Without a card, `build_body()` with no device raises."""
    path = _hand_written(str(tmp_path / "hand.vxa"), "ZLIB")
    jb = jvxa.load_vxa(path).build_body()
    doc = pvxa.load_vxa(path)
    body = doc.build_body(device="cpu")
    ref = convert.body_from_numpy(jax.tree_util.tree_map(np.asarray, jb))
    assert body.all_linear is False and ref.all_linear is False
    for f in dataclasses.fields(body):
        a, b = getattr(body, f.name), getattr(ref, f.name)
        if torch.is_tensor(a):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0, msg=f.name)
        elif f.name not in ("collision", "mesh_drag"):
            assert a == b, f.name
    assert int((body.dof_fixed != 0).sum()) > 0 and float(body.external_force.abs().sum()) > 0
    assert body.ss_strain_vox is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            doc.build_body()


def test_read_fitness_xml(tmp_path):
    path = tmp_path / "fit.xml"
    path.write_text("<?xml version=\"1.0\"?>\n<Voxelyze_Sim_Result Version=\"1\">\n"
                    "<Fitness><NormFinalDist>1.25</NormFinalDist><FinalDist>0.5</FinalDist>"
                    "<Lifetime>5</Lifetime></Fitness><Name>run</Name>\n"
                    "</Voxelyze_Sim_Result>\n")
    got = pvxa.read_fitness_xml(str(path))
    assert got == jvxa.read_fitness_xml(str(path))
    assert got["NormFinalDist"] == 1.25 and got["Name"] == "run"
